"""One step of every distributed path of the port over an n-shard mesh
(the checks of the reference's ``__graft_entry__.dryrun_multichip``).

    python -m tpu_deflate_torch.dist.dryrun [N]

runs it on N shards of the first CUDA device; ``dryrun_multichip(n,
devices=[cpu] * n)`` runs it on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import gzip
import sys

import numpy as np
import torch

from . import mesh as dm
from . import sharded as ds


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def code_tables(L: int, n_lit: int = 256, n_dist: int = 4):
    """Dynamic code tables for L lanes from flat histograms (the first
    ``n_lit`` literals, EOB and the first ``n_dist`` distance codes), as
    the encoder's planning hands them to the emit: (ll_codes, d_codes,
    header_vals (uint32 in int64), header_bits, eob_val, eob_bits)."""
    from ..codec.encode_np import MAX_CODE_BITS, build_headers, pack_codes
    from ..kernels.huffman import huffman_lengths_batch

    hist = np.zeros((L, 288), np.int64)
    hist[:, :n_lit] = 1
    hist[:, 256] = 1
    d_hist = np.zeros((L, 30), np.int64)
    d_hist[:, :n_dist] = 1
    ll_len = huffman_lengths_batch(hist, MAX_CODE_BITS)
    d_len = huffman_lengths_batch(d_hist, MAX_CODE_BITS)
    ll_codes = pack_codes(ll_len, MAX_CODE_BITS)
    d_codes = pack_codes(d_len, MAX_CODE_BITS)
    header_vals, header_bits = build_headers(ll_len, d_len)
    return (ll_codes, d_codes, header_vals.astype(np.int64), header_bits,
            (ll_codes[:, 256] & 0xFFFF).astype(np.int64), ll_codes[:, 256] >> 16)


def analyze_emit(data: torch.Tensor, lengths: torch.Tensor, *tables):
    """The unsharded encode step on data's device: analysis, then emit."""
    from ..codec import encode as pe
    from ..codec.emit import emit_device

    a = pe.analyze(data, lengths, True)
    flags = a["is_token"].to(torch.int32) | (a["is_match"].to(torch.int32) << 1)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(data.device) for x in tables]
    return emit_device(a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"], a["dist_eb"],
                       a["dist_ev"], *t)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Shard every distributed path over an n-shard mesh and run one step
    of each on tiny shapes, checking each against its unsharded run:
    the lane-sharded analysis and emit (also over the 2-D pod mesh), the
    ring halo exchange (also primed with a broadcast preset dictionary),
    the stats sum, the ordered ragged gather, the sharded decode (every
    member resolved on the device), the sharded resolve, the sharded
    continuous-history encodes (device and C core) and the gated
    ``init_distributed``. ``devices`` (default: the first n CUDA devices)
    may repeat a device. Raises RuntimeError on the first difference."""
    from ..codec import continuous as pc
    from ..codec import decode_v2 as pv2
    from ..codec import resolve as rs
    from .. import native

    devs = list(devices) if devices is not None else None
    mesh = dm.make_codec_mesh(n_devices, devices=devs)
    dev0 = mesh.devices[0]
    L, S = 2 * n_devices, 2048
    rng = np.random.default_rng(0)
    data = np.repeat(rng.integers(0, 8, (L, S // 8), dtype=np.uint8), 8, axis=1)
    lengths = np.full(L, S, dtype=np.int32)
    tables = code_tables(L)

    # lanes sharded: analysis (match find, K8, K9) and emit (K10)
    words, total_bits = ds.sharded_analyze_emit(mesh)(data, lengths, *tables)
    w1, b1 = analyze_emit(torch.from_numpy(data).to(dev0), torch.from_numpy(lengths).to(dev0), *tables)
    _check(torch.equal(words, w1) and torch.equal(total_bits, b1), "sharded analyze+emit differs")

    # the ring halo exchange of 32 KiB history windows
    shards = rng.integers(0, 255, (n_devices, 40 * 1024), dtype=np.uint8)
    haloed = ds.halo_exchange(shards, mesh)
    _check(tuple(haloed.shape) == (n_devices, 72 * 1024), f"halo shape {tuple(haloed.shape)}")
    _check(not haloed[0, : 32 * 1024].any().item(), "shard 0's halo is not zeros")
    for d in range(1, n_devices):
        _check(np.array_equal(haloed[d, : 32 * 1024].cpu().numpy(), shards[d - 1, -32 * 1024 :]), "halo")

    # the stats sum and the ordered ragged gather of the emitted lanes
    stats = ds.psum_stats(np.ones((L, 8), np.int32), mesh)
    _check(torch.equal(stats.cpu(), torch.full((L // n_devices, 8), n_devices, dtype=torch.int32)), "psum")
    nbytes = ((total_bits + 7) // 8).cpu().numpy().astype(np.int32)
    wbytes = words.cpu().numpy().view(np.uint8)
    gathered, glens = ds.ordered_ragged_gather(wbytes, nbytes, mesh)
    _check(np.array_equal(gathered, wbytes) and np.array_equal(glens, nbytes), "ordered ragged gather")

    # the sharded decode: waves, resolve and CRC per shard
    plain = rng.integers(0, 8, 2 * n_devices * 4096, dtype=np.uint8).tobytes()
    gz = native.compress_members_native(plain, member_data=4096)
    _check(pv2.gzip_decompress_v2(gz, mesh=mesh, device_resolve="on") == plain, "sharded decode")
    st = pv2.LAST_DECODE_STATS
    _check(st["device_resolved"] == st["members"] - st["stored"], f"a member left the device: {st}")

    # the sharded resolve (K5, K6) against the unsharded one
    tok = np.full((n_devices, rs.N_POS), -1, np.int32)
    for i in range(n_devices):
        tok[i, :4] = [65 + i, 66, rs.TOKEN_MATCH_BIT | (258 << 16) | 1, rs.TOKEN_MATCH_BIT | (17 << 16) | 199]
    ys, summs = ds.sharded_resolve(mesh)(tok)
    y1, summ1 = rs.resolve_tokens_device(torch.from_numpy(tok).to(dev0))
    _check(torch.equal(ys, y1) and torch.equal(summs, summ1), "sharded resolve differs")
    _check(int(summ1[:, 3].sum()) == 0, "sharded resolve residue")

    # the continuous-history device encode, sharded, against its one-device run
    small = np.repeat(rng.integers(97, 123, 900, dtype=np.uint8), 3).tobytes()
    one = pc.compress_continuous(small, device=dev0, effort=4, block_data=1024, lane_batch=4)
    _check(pc.compress_continuous(small, mesh=mesh, effort=4, block_data=1024, lane_batch=4) == one,
           "sharded continuous device encode differs")
    _check(gzip.decompress(one) == small, "continuous device encode round trip")

    # the halo-fed continuous-history encode in the C core
    big = np.repeat(rng.integers(0, 16, n_devices * 3000, dtype=np.uint8), 3).tobytes()
    _check(gzip.decompress(ds.sharded_continuous_compress(big, mesh)) == big, "sharded continuous encode")

    # the gated bring-up, and the 2-D (host, data) pod mesh with a preset dictionary
    dm.init_distributed()
    if n_devices >= 4 and n_devices % 2 == 0:
        pod = dm.make_pod_mesh(2, n_devices // 2, devices=devs)
        if pod.rank_axis is None:
            w2, b2 = ds.sharded_analyze_emit(pod, ("host", "data"))(data, lengths, *tables)
            _check(torch.equal(w2, w1) and torch.equal(b2, b1), "pod-mesh analyze+emit differs")
            pd = ds.broadcast_preset_dict(b"example-dictionary" * 64, pod)
            h2 = ds.halo_exchange(shards, mesh, preset_dict=pd)
            want = np.frombuffer((b"example-dictionary" * 64), np.uint8)
            _check(np.array_equal(h2[0, 32 * 1024 - want.size : 32 * 1024].cpu().numpy(), want), "preset halo")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dryrun_multichip(n, devices=[torch.device("cuda")] * n)
    print("dryrun ok")
