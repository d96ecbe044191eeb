"""The port's distribution (``tpu_deflate_torch.dist``) against the JAX
package's (``tpu_deflate.dist``): one counterpart of each case of
``test_dist.py``. The port's mesh is 8 entries of the CPU
(``make_codec_mesh(devices=[cpu] * 8)``), the reference's the conftest's 8
virtual CPU devices. Inputs are made from numpy seeds; every step is
integer-only, so the tolerance is exact equality. Also: the sharded
encodes byte-identical to the port's unsharded ones, the sharded decode
resolving every Huffman member on the device (the reference's mesh path
resolves none there: F5), the front doors' ``mesh=`` and ``FrameworkConfig``
with a ``MeshConfig``."""

from __future__ import annotations

import gzip
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate import DataFormatError as RefDataFormatError
from tpu_deflate import native as ref_native
from tpu_deflate.codec import encode_jax as ej
from tpu_deflate.codec import resolve_pallas as rp
from tpu_deflate.dist import mesh as ref_mesh
from tpu_deflate.dist import sharded as ref_sharded
from tpu_deflate.engine import decompress as ref_decompress
from tpu_deflate.kernels.huffman import huffman_lengths_batch
from tpu_deflate_torch import engine, native
from tpu_deflate_torch.codec import continuous as pc
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.codec import resolve as rs
from tpu_deflate_torch.config import DecoderConfig, EncoderConfig, FrameworkConfig, MeshConfig
from tpu_deflate_torch.dist import dryrun, sharded
from tpu_deflate_torch.dist.mesh import (
    init_distributed,
    lane_sharding,
    make_codec_mesh,
    make_pod_mesh,
    mesh_from_config,
    pad_lanes,
    replicated,
)
from tpu_deflate_torch.format.errors import DataFormatError

CPU = torch.device("cpu")
WINDOW = 32 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_codec_mesh(devices=[CPU] * 8)


@pytest.fixture(scope="module")
def rmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return ref_mesh.make_codec_mesh(8)


@pytest.fixture
def cpu_engine(monkeypatch):
    """The front doors on the CPU: the device they ask for becomes the CPU."""
    monkeypatch.setattr(engine, "_cuda", lambda name: CPU)


def test_halo_exchange_ring(mesh, rmesh):
    rng = np.random.default_rng(0)
    shards = rng.integers(0, 256, (8, WINDOW + 100), dtype=np.uint8)
    got = sharded.halo_exchange(shards, mesh).numpy()
    want = np.asarray(ref_sharded.halo_exchange(jnp.asarray(shards), rmesh))
    assert got.shape == (8, 2 * WINDOW + 100)
    np.testing.assert_array_equal(got, want)
    assert (got[0, :WINDOW] == 0).all()


def test_halo_exchange_blocks_and_short_rows(mesh, rmesh):
    """16 rows on 8 shards (two rows a shard), rows shorter than the window."""
    rng = np.random.default_rng(10)
    shards = rng.integers(0, 256, (16, 5000), dtype=np.uint8)
    got = sharded.halo_exchange(torch.from_numpy(shards), mesh).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_sharded.halo_exchange(jnp.asarray(shards), rmesh)))


def test_psum_stats(mesh, rmesh):
    vals = np.arange(16 * 4, dtype=np.int32).reshape(16, 4)
    got = sharded.psum_stats(vals, mesh).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_sharded.psum_stats(jnp.asarray(vals), rmesh)))


def test_ordered_ragged_gather(mesh, rmesh):
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    lengths = rng.integers(1, 64, 8).astype(np.int32)
    gp, gl = sharded.ordered_ragged_gather(payload, lengths, mesh)
    rp_, rl = ref_sharded.ordered_ragged_gather(jnp.asarray(payload), jnp.asarray(lengths), rmesh)
    np.testing.assert_array_equal(gp, rp_)
    np.testing.assert_array_equal(gl, rl)
    got = b"".join(gp[i, : gl[i]].tobytes() for i in range(8))
    assert got == b"".join(payload[i, : lengths[i]].tobytes() for i in range(8))


def _encode_args(seed: int):
    """The reference test's encode step inputs: 8 lanes of 4096 bytes and
    flat-histogram code tables, in the dtypes each package's emit takes."""
    rng = np.random.default_rng(seed)
    L, S = 8, 4096
    data = np.repeat(rng.integers(0, 16, (L, S // 4), dtype=np.uint8), 4, axis=1)
    lengths = np.full(L, S, dtype=np.int32)
    hist = np.ones((L, 288), dtype=np.int64)
    ll_lengths = huffman_lengths_batch(hist, 12)
    d_hist = np.zeros((L, 30), dtype=np.int64)
    d_hist[:, :8] = 1
    d_lengths = huffman_lengths_batch(d_hist, 12)
    ll_codes = ej._pack_codes(ll_lengths, 12)
    d_codes = ej._pack_codes(d_lengths, 12)
    header_vals, header_bits = ej._build_headers(ll_lengths, d_lengths)
    eob_val = (ll_codes[:, 256] & 0xFFFF).astype(np.uint32)
    eob_bits = (ll_codes[:, 256] >> 16).astype(np.int32)
    ref = (data, lengths, ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits)
    port = (data, lengths, ll_codes.astype(np.int32), d_codes.astype(np.int32),
            header_vals.astype(np.int64), header_bits.astype(np.int32), eob_val.astype(np.int64), eob_bits)
    return ref, port


def _ref_analyze_emit(args):
    a = ej.analyze_device(jnp.asarray(args[0]), jnp.asarray(args[1]), True)
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    words, bits = ej.emit_device(a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"],
                                 a["dist_eb"], a["dist_ev"], *(jnp.asarray(x) for x in args[2:]))
    return np.asarray(words), np.asarray(bits)


def test_sharded_encode_matches_single_chip(mesh):
    """The sharded analysis and emit equal the port's unsharded run."""
    _ref, port = _encode_args(2)
    words, bits = sharded.sharded_analyze_emit(mesh)(*port)
    w1, b1 = dryrun.analyze_emit(torch.from_numpy(port[0]), torch.from_numpy(port[1]), *port[2:])
    assert torch.equal(words, w1) and torch.equal(bits, b1)


def test_dryrun_multichip():
    """The port's counterpart of ``__graft_entry__.dryrun_multichip(8)``."""
    dryrun.dryrun_multichip(8, devices=[CPU] * 8)


def test_pod_mesh_and_halo_on_2d():
    mesh2 = make_pod_mesh(2, 4, devices=[CPU] * 8)
    assert mesh2.shape == (2, 4)
    assert mesh2.axis_names == ("host", "data")
    assert lane_sharding(mesh2, ("host", "data")).n == 8 and lane_sharding(mesh2, "data").n == 4
    vals = np.arange(4 * 6, dtype=np.int32).reshape(4, 6)
    out = sharded.psum_stats(vals, make_codec_mesh(devices=[CPU] * 4)).numpy()
    np.testing.assert_array_equal(out.reshape(6), vals.sum(axis=0))


def test_lane_sharding_bounds_and_padding(mesh):
    sh = lane_sharding(mesh)
    assert pad_lanes(13, 8) == 16 and pad_lanes(16, 8) == 16
    assert sh.bounds(16) == [(2 * k, 2 * k + 2) for k in range(8)]
    # the shards past the real lanes (padding only) are left out
    assert sh.bounds(16, real=13) == [(2 * k, 2 * k + 2) for k in range(7)]
    assert sh.bounds(16, real=1) == [(0, 2)]
    with pytest.raises(ValueError):
        sh.bounds(13)
    assert replicated(mesh) == (CPU,)


def _decode_input():
    """test_dist.py's 400,000-byte input, as the C core's members."""
    rng = random.Random(0)
    words = [bytes(rng.getrandbits(8) for _ in range(rng.randint(2, 9))) for _ in range(50)]
    data = bytearray()
    while len(data) < 400_000:
        data += rng.choice(words)
    data = bytes(data[:400_000])
    return data, native.compress_members_native(data)


def _reason(fn, gz):
    try:
        fn(gz)
    except (DataFormatError, RefDataFormatError) as e:
        return e.reason.name
    return None


def test_sharded_decode_bit_exact(mesh, rmesh, cpu_engine):
    """engine.decompress over the mesh equals the reference's mesh decode,
    byte for byte and Reason for Reason, and every Huffman member resolves
    on the device (F5: the reference's mesh path resolves none there)."""
    data, gz = _decode_input()
    assert ref_native.compress_members_native(data) == gz
    on = DecoderConfig(device_resolve="on")
    got = engine.decompress(gz, mesh=mesh, config=on)
    stats = dict(pv2.LAST_DECODE_STATS)
    assert got == ref_decompress(gz, mesh=rmesh) == data
    assert stats["device_resolved"] == stats["members"] - stats["stored"] > 1
    assert stats["host_resolved"] == 0

    bad = bytearray(gz)
    bad[len(bad) // 3] ^= 0x11
    want = _reason(lambda b: ref_decompress(b, mesh=rmesh), bytes(bad))
    assert want is not None
    assert _reason(lambda b: engine.decompress(b, mesh=mesh, config=on), bytes(bad)) == want
    assert _reason(lambda b: engine.decompress(b, config=on), bytes(bad)) == want


@pytest.mark.parametrize("route", ["on", "off"])
def test_sharded_decode_routes_match_single_device(mesh, route):
    """Multi-block members (the device route, or the host route's K7
    pull), single-block ones and a stored member, over a 3-shard mesh that
    divides no wave: the bytes and the routing stats of the one-device
    decode."""
    rng = np.random.default_rng(4)
    text = np.frombuffer(_decode_input()[0], np.uint8)
    parts = [text[:150_000].tobytes(), rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
             text[200_000:270_000].tobytes()]
    gz = native.compress_members_native(parts[0]) + pc.compress_continuous(parts[2], device=CPU, block_data=16384)
    gz += native.compress_members_native(parts[1], member_data=4096)
    want = b"".join((parts[0], parts[2], parts[1]))
    three = make_codec_mesh(devices=[CPU] * 3)
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve=route) == want
    single = {k: v for k, v in pv2.LAST_DECODE_STATS.items() if k != "launches"}
    assert pv2.gzip_decompress_v2(gz, mesh=three, device_resolve=route) == want
    assert {k: v for k, v in pv2.LAST_DECODE_STATS.items() if k != "launches"} == single


def test_decode_streams_mesh_matches_device():
    """decode_deflate_streams_v2(mesh=) gives each lane's tokens, size and
    error of the one-device walk, padding lanes changing nothing."""
    data = _decode_input()[0]
    payloads = [gzip.compress(data[i * 9000 : i * 9000 + 20000 + 500 * i])[10:-8] for i in range(5)]
    payloads[3] = payloads[3][: len(payloads[3]) // 2]  # truncated: UNEXPECTED_END
    one = pv2.decode_deflate_streams_v2(payloads, CPU)
    many = pv2.decode_deflate_streams_v2(payloads, mesh=make_codec_mesh(devices=[CPU] * 8))
    for a, b in zip(one, many):
        assert (a.err, a.out_total, a.bitpos) == (b.err, b.out_total, b.bitpos)
        assert np.array_equal(np.concatenate(a.tokens), np.concatenate(b.tokens))
    assert one[3].err and not any(st.err for i, st in enumerate(one) if i != 3)


def test_init_distributed_gated(monkeypatch):
    for var in ("TD_COORDINATOR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_preset_dict_broadcast_and_halo(mesh, rmesh):
    rng = np.random.default_rng(7)
    d = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    pd = sharded.broadcast_preset_dict(d, mesh)
    rpd = ref_sharded.broadcast_preset_dict(d, rmesh)
    assert list(pd) == [CPU]
    np.testing.assert_array_equal(pd[CPU].numpy(), np.asarray(rpd))
    shards = rng.integers(0, 256, (8, WINDOW + 64), dtype=np.uint8)
    got = sharded.halo_exchange(shards, mesh, preset_dict=pd).numpy()
    want = np.asarray(ref_sharded.halo_exchange(jnp.asarray(shards), rmesh, preset_dict=rpd))
    np.testing.assert_array_equal(got, want)


def test_pod_2d_encode_matches_single_chip():
    """Lanes over the (host, data) product of a 2-D pod mesh: the port's
    words and bits equal its unsharded run's and the reference's."""
    ref, port = _encode_args(3)
    mesh2 = make_pod_mesh(2, 4, devices=[CPU] * 8)
    words, bits = sharded.sharded_analyze_emit(mesh2, ("host", "data"))(*port)
    w1, b1 = dryrun.analyze_emit(torch.from_numpy(port[0]), torch.from_numpy(port[1]), *port[2:])
    assert torch.equal(words, w1) and torch.equal(bits, b1)
    rw, rb = _ref_analyze_emit(ref)
    np.testing.assert_array_equal(bits.numpy(), rb)
    # the reference's word grid here is narrower than the port's fixed one
    W = rw.shape[1]
    np.testing.assert_array_equal(words[:, :W].numpy(), rw.view(np.int32))
    assert not words[:, W:].any()


def _words_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(150)]
    return np.concatenate([words[i] for i in rng.integers(0, 150, n // 3)])[:n].tobytes()


def test_sharded_continuous_compress(mesh, rmesh):
    """The halo-fed C-core encode over the mesh: the reference's bytes, one
    member that gzip reads back, within the serial encoder's ratio."""
    data = _words_text(1 << 20, 21)
    gz = sharded.sharded_continuous_compress(data, mesh, block_data=32 * 1024, max_chain=128)
    assert gz == ref_sharded.sharded_continuous_compress(data, rmesh, block_data=32 * 1024, max_chain=128)
    assert gzip.decompress(gz) == data
    serial = ref_native.compress_continuous_native(data, block_data=32 * 1024, max_chain=128)
    assert len(gz) / len(data) <= len(serial) / len(data) + 0.001


@pytest.mark.parametrize("n", [1, 100, 70000, 300001])
def test_sharded_continuous_tiny_and_ragged(mesh, rmesh, n):
    data = (b"abcdefgh" * ((n + 7) // 8))[:n]
    gz = sharded.sharded_continuous_compress(data, mesh, block_data=16 * 1024)
    assert gz == ref_sharded.sharded_continuous_compress(data, rmesh, block_data=16 * 1024)
    assert gzip.decompress(gz) == data


def _mixed(n: int, seed: int) -> bytes:
    """Text, a run of zeros and random bytes: the C core stores some blocks."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(200)]
    text = np.concatenate([words[i] for i in rng.integers(0, 200, n // 3)])[: n - 20000]
    return text.tobytes() + bytes(12000) + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes()


def test_sharded_continuous_f13():
    """F13: the reference splices a shard that holds a stored block at a
    bit offset that is not a multiple of 8 unchanged, so the block's
    padding is wrong and its stream fails to decode; the port encodes that
    shard again at its true offset."""
    data = _mixed(120_000, 10)
    ref = ref_sharded.sharded_continuous_compress(data, ref_mesh.make_codec_mesh(3), block_data=16384)
    with pytest.raises(zlib.error):
        zlib.decompress(ref, 31)
    got = sharded.sharded_continuous_compress(data, make_codec_mesh(devices=[CPU] * 3), block_data=16384)
    assert gzip.decompress(got) == data
    one = sharded.sharded_continuous_compress(data, make_codec_mesh(devices=[CPU]), block_data=16384)
    assert one == ref_sharded.sharded_continuous_compress(data, ref_mesh.make_codec_mesh(1), block_data=16384)


def test_bit_splice_matches_reference():
    """The sharded encode splices with codec.continuous.BitSplicer: the
    reference's _bit_splice, stream for stream."""
    rng = np.random.default_rng(14)
    streams = []
    for nbits in (0, 5, 8, 13, 1, 64, 7, 300):
        sb = bytearray(rng.integers(0, 256, -(-nbits // 8), dtype=np.uint8).tobytes())
        if nbits % 8:
            sb[-1] &= (1 << (nbits % 8)) - 1
        streams.append((bytes(sb), nbits))
    sp = pc.BitSplicer()
    for sb, nbits in streams:
        sp.append(sb, nbits)
    assert (sp.payload(), sp.bitpos) == ref_sharded._bit_splice(streams)


def test_sharded_continuous_preset_dict(mesh, rmesh):
    data = _words_text(200_000, 5)
    d = _words_text(40_000, 6)
    got = sharded.sharded_continuous_compress(data, mesh, preset_dict=d)
    assert got == ref_sharded.sharded_continuous_compress(data, rmesh, preset_dict=d)


def test_sharded_resolve_bit_exact(mesh, rmesh):
    """The sharded K5/K6 equal the reference's sharded resolve (its Pallas
    kernels in interpret mode) and the port's unsharded resolve."""
    rng = np.random.default_rng(9)
    L = 8
    tokarr = np.full((L, rp.N_POS), -1, np.int32)
    for i in range(L):
        out, k = 0, 0
        while out < 3000:
            if rng.random() < 0.5 or out < 4:
                tokarr[i, k] = int(rng.integers(0, 256))
                out += 1
            else:
                run = int(rng.integers(3, 259))
                dist = int(rng.integers(1, min(out, 2000) + 1))
                tokarr[i, k] = rp.TOKEN_MATCH_BIT | run << 16 | (dist - 1)
                out += run
            k += 1
    ys, summs = sharded.sharded_resolve(mesh)(tokarr)
    rys, rsumms = ref_sharded.sharded_resolve(rmesh)(jnp.asarray(tokarr))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(rys))
    np.testing.assert_array_equal(summs.numpy(), np.asarray(rsumms))
    y1, summ1 = rs.resolve_tokens_device(torch.from_numpy(tokarr))
    assert torch.equal(ys, y1) and torch.equal(summs, summ1)
    assert int(summ1[:, 3].sum()) == 0


def test_compress_effort4_mesh_matches_unsharded(cpu_engine):
    """engine.compress at effort 4 over 3 shards (5 lanes a batch: the mesh
    divides no batch) is the unsharded member, byte for byte; below effort
    4 the mesh is ignored."""
    data = _words_text(9 * 4096 + 77, 12)
    cfg = EncoderConfig(lookahead=4096)
    three = make_codec_mesh(devices=[CPU] * 3)
    want = pc.compress_continuous(data, device=CPU, effort=4, block_data=4096)
    assert engine.compress(data, effort=4, config=cfg, mesh=three) == want
    assert pc.compress_continuous(data, mesh=three, effort=4, block_data=4096, lane_batch=5) == want
    assert gzip.decompress(want) == data
    assert engine.compress(data[:5000], effort=2, mesh=three) == pe.compress_members(data[:5000], device=CPU)


def test_framework_config_builds_the_mesh(cpu_engine):
    """A FrameworkConfig with a non-trivial MeshConfig takes the mesh path
    of both front doors; the trivial one takes none."""
    assert mesh_from_config(MeshConfig()) is None
    four = mesh_from_config(MeshConfig(chips_per_host=4), devices=[CPU] * 4)
    pod = mesh_from_config(MeshConfig(hosts=2, chips_per_host=2), devices=[CPU] * 4)
    assert four.shape == (4,) and pod.shape == (2, 2) and pod.axis_names == ("host", "data")
    data = _words_text(3 * 4096 + 5, 13)
    cfg = FrameworkConfig(encoder=EncoderConfig(effort=4, lookahead=4096),
                          decoder=DecoderConfig(device_resolve="on"),
                          mesh=MeshConfig(hosts=2, chips_per_host=2))
    gz = engine.compress(data, config=cfg)
    assert gz == pc.compress_continuous(data, device=CPU, effort=4, block_data=4096)
    assert engine.decompress(gz, config=cfg) == data
    assert pv2.LAST_DECODE_STATS["device_resolved"] == 1


def test_cuda_engine_refuses_a_cpu_mesh(monkeypatch, mesh):
    monkeypatch.setattr(engine, "_cuda", lambda name: torch.device("cuda"))
    with pytest.raises(ValueError, match="mesh"):
        engine.decompress(b"", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        engine.compress(b"x", effort=4, mesh=mesh)


def test_mesh_of_mixed_devices_is_refused():
    with pytest.raises(ValueError):
        make_codec_mesh(devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError):
        pv2.gzip_decompress_v2(b"", device=CPU, mesh=make_codec_mesh(devices=[CPU]))
