"""Mesh-sharded codec steps of the port (counterpart of
``tpu_deflate.dist.sharded``).

Members (lanes) are independent, so the batched codec steps cut their lane
axis over the mesh's shards (``dist.mesh.lane_sharding``) and run each shard's
kernels on its own device, with no exchange on the hot path. Data moves
between shards only where the format needs it:

- :func:`halo_exchange`: each shard's last 32 KiB to its successor, so a
  continuous-history encode reaches into the previous shard's history;
- :func:`psum_stats`: per-shard stat vectors summed;
- :func:`ordered_ragged_gather`: ragged per-lane payloads gathered in lane
  order;
- :func:`broadcast_preset_dict`: a zlib preset dictionary on every device.

Inside one process these are copies between the mesh's devices. Across
ranks (a mesh whose host axis is the ranks) they are ``torch.distributed``
calls: a ``broadcast``, an ``isend``/``irecv`` ring, an ``all_reduce`` and
an ``all_gather``. Every function takes the whole lane axis on every rank,
reads only this rank's shards of it, and returns the whole result.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as tdist

from .. import native
from ..codec.continuous import BitSplicer
from ..codec.encode_np import build_member
from .mesh import CodecMesh, LaneSharding, comm_device, lane_sharding, replicated

WINDOW_SIZE = 32 * 1024  # the DEFLATE window: what LZ77 can reach back


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def broadcast_preset_dict(dictionary: bytes, mesh: CodecMesh) -> dict:
    """A zlib preset dictionary's last 32 KiB (the only part LZ77 can
    reach), left-padded with zeros, as one (WINDOW_SIZE,) uint8 copy on
    each device of the mesh: {device: tensor}. Across ranks, rank 0's
    dictionary is broadcast to every rank."""
    arr = np.zeros(WINDOW_SIZE, np.uint8)
    tail = np.frombuffer(dictionary[-WINDOW_SIZE:], dtype=np.uint8)
    if tail.size:
        arr[-tail.size :] = tail
    devs = replicated(mesh)
    t = torch.from_numpy(arr)
    if mesh.rank_axis is not None:
        t = t.to(comm_device(devs[0]))
        tdist.broadcast(t, src=0)
    return {dev: t.to(dev) for dev in devs}


def _ring_from_previous(t: torch.Tensor, sh: LaneSharding) -> torch.Tensor:
    """t from the previous rank of the ring (each rank sends its own to the
    next): one isend/irecv pair a rank."""
    world, rank = tdist.get_world_size(), tdist.get_rank()
    send = t.to(comm_device(sh.devices[0])).contiguous()
    if world == 1:
        return send
    recv = torch.empty_like(send)
    reqs = tdist.batch_isend_irecv([
        tdist.P2POp(tdist.isend, send, (rank + 1) % world),
        tdist.P2POp(tdist.irecv, recv, (rank - 1) % world),
    ])
    for req in reqs:
        req.wait()
    return recv


def _halo_shards(shards, sh: LaneSharding, preset_dict) -> list[torch.Tensor]:
    """This process's blocks of :func:`halo_exchange`, each on its device."""
    parts = sh.split(_tensor(shards))
    rows, width = parts[0].shape
    H = min(WINDOW_SIZE, width)  # short shards carry all they have
    tails = [p[:, -H:] for p in parts]
    prev = _ring_from_previous(tails[-1], sh) if sh.across_ranks else None
    if sh.first > 0:
        head = prev
    elif preset_dict is None:
        head = torch.zeros((rows, H), dtype=torch.uint8)
    else:
        d0 = preset_dict if isinstance(preset_dict, torch.Tensor) else next(iter(preset_dict.values()))
        head = d0[-H:].expand(rows, H)
    return [torch.cat([h.to(p.device), p], dim=1) for h, p in zip([head, *tails[:-1]], parts)]


def halo_exchange(shards, mesh: CodecMesh, axis="data", preset_dict=None) -> torch.Tensor:
    """Prepend each shard with the previous shard's last 32 KiB.

    shards: (D, S) uint8 (a tensor or an array), D a multiple of the shard
    count n: block k of D / n rows is shard k's, and row i of block k gets
    the tail of row i of block k - 1. Returns (D, H + S) uint8 on the mesh's
    first device, H = min(32768, S). Block 0's halo is the preset dictionary
    (:func:`broadcast_preset_dict`'s copies, or one (WINDOW_SIZE,) tensor)
    when given, zeros otherwise. Across ranks each rank's last block goes
    to the next rank through the ring."""
    sh = lane_sharding(mesh, axis)
    return sh.gather(_halo_shards(shards, sh, preset_dict))


def psum_stats(values, mesh: CodecMesh, axis="data") -> torch.Tensor:
    """Sum per-shard stat blocks across the mesh: values (L, k), block k of
    L / n rows per shard -> their sum (L / n, k) on the mesh's first device
    (an ``all_reduce`` across ranks)."""
    sh = lane_sharding(mesh, axis)
    out = sh.devices[0]
    total = sum(p.to(out) for p in sh.split(_tensor(values)))
    if sh.across_ranks:
        t = total.to(comm_device(out))
        tdist.all_reduce(t)
        total = t.to(out)
    return total


def ordered_ragged_gather(payload, lengths, mesh: CodecMesh, axis="data") -> tuple[np.ndarray, np.ndarray]:
    """All ragged per-lane payloads in lane order, on the host: payload
    (L, W) fixed-width rows with lengths (L,) valid bytes each, sharded on
    L -> (payload, lengths) as arrays (an ``all_gather`` across ranks). The
    caller takes row i's first lengths[i] bytes, in order (the in-order
    member append of a gzip stream)."""
    sh = lane_sharding(mesh, axis)
    p = sh.gather(sh.split(_tensor(payload)))
    n = sh.gather(sh.split(_tensor(lengths)))
    return p.cpu().numpy(), n.cpu().numpy()


def _gather_streams(streams: list[tuple], sh: LaneSharding) -> list[tuple]:
    """Every shard's (bytes, int, ...) record in shard order: this
    process's local ones, and across ranks every rank's, the bytes as rows
    padded to the longest with their lengths (:func:`ordered_ragged_gather`'s
    layout)."""
    if not sh.across_ranks:
        return streams
    comm = comm_device(sh.devices[0])
    width = torch.tensor([max(len(b) for b, *_ in streams)], device=comm)
    tdist.all_reduce(width, op=tdist.ReduceOp.MAX)
    rows = np.zeros((len(streams), int(width)), np.uint8)
    for i, (b, *_rest) in enumerate(streams):
        rows[i, : len(b)] = np.frombuffer(b, np.uint8)
    meta = np.array([[len(b), *rest] for b, *rest in streams], np.int64)
    g_rows = sh.gather([torch.from_numpy(rows)]).cpu().numpy()
    g_meta = sh.gather([torch.from_numpy(meta)]).cpu().numpy()
    return [(g_rows[i, :n].tobytes(), *(int(v) for v in rest)) for i, (n, *rest) in enumerate(g_meta)]


NOT_A_FORMAT_ERROR = -1  # a rank's failure code for an exception that is not a DataFormatError


def rank_results(out: bytes, failure: Exception | None, mesh: CodecMesh) -> bytes:
    """Join each rank's part of a result in rank order, or raise.

    ``failure`` is the exception this rank's part raised (None for none);
    every rank must call this, whatever its part did, since the ranks
    exchange their failures first. If any rank failed, every rank raises,
    after the first failing rank in rank order: that rank re-raises its own
    exception, and the others raise its DataFormatError's Reason, or a
    RuntimeError naming it where its failure was of another kind."""
    from ..format.errors import DataFormatError, check_device_error, reason_to_code

    if failure is None:
        code = 0
    elif isinstance(failure, DataFormatError):
        code = reason_to_code(failure.reason)
    else:
        code = NOT_A_FORMAT_ERROR
    sh = lane_sharding(mesh, mesh.rank_axis)
    comm = comm_device(sh.devices[0])
    codes = [torch.zeros(1, dtype=torch.int64, device=comm) for _ in range(mesh.world)]
    tdist.all_gather(codes, torch.tensor([code], dtype=torch.int64, device=comm))
    for r, c in enumerate(int(c) for c in codes):
        if c == 0:
            continue
        if r == mesh.rank:
            raise failure
        if c == NOT_A_FORMAT_ERROR:
            raise RuntimeError(f"rank {r} failed its part of the call (not a data format error: see its own error)")
        check_device_error(c, f"raised on rank {r}")
    return b"".join(b for (b,) in _gather_streams([(out,)], sh))


def _deflate_shard(buf_with_halo: bytes, halo: int, ln: int, final: bool, *, block_data: int,
                   max_code_len: int, max_chain: int, start_bit: int = 0) -> tuple[bytes, int, bool]:
    """Encode one shard's blocks of ``block_data`` bytes bit-contiguously
    with the C core, the first block's history from the ``halo`` bytes
    before it (the previous shard's last 32 KiB), from bit ``start_bit`` of
    the first byte on (the bits below it zero) -> (bytes, bits counted from
    bit 0, whether a block was stored: a stored block pads to a byte from
    where it starts, so it is right only at its true offset)."""
    out = bytearray()
    partial = pos = 0
    bitpos = start_bit
    stored = False
    while pos < ln:
        blk = min(block_data, ln - pos)
        h = min(WINDOW_SIZE, halo + pos)
        start = halo + pos - h
        fin = final and pos + blk >= ln
        raw, bits = native.deflate_block(buf_with_halo[start : halo + pos + blk], h, blk, fin, bitpos,
                                         partial, max_code_len, max_chain)
        stored |= ((int.from_bytes(raw[:2], "little") >> (bitpos + 1)) & 3) == 0  # btype 00
        whole, bitpos = divmod(bits, 8)
        out += raw[:whole]
        partial = raw[whole] if bitpos else 0
        pos += blk
    total_bits = 8 * len(out) + bitpos
    if bitpos:
        out.append(partial)
    return bytes(out), total_bits, stored


def sharded_continuous_compress(data: bytes, mesh: CodecMesh, *, axis="data", block_data: int = 64 * 1024,
                                max_code_len: int = 15, max_chain: int = 512,
                                preset_dict: bytes | None = None) -> bytes:
    """Max-ratio gzip (continuous 32 KiB history) in one member, sharded
    over a mesh, byte-identical to the reference's.

    The input cuts into one contiguous row a shard, a whole number of
    ``block_data`` blocks each; :func:`halo_exchange` carries each row's
    last 32 KiB to the next shard on the devices (shard 0 takes the preset
    dictionary when given); each shard's blocks are encoded by the C core
    against its halo, the shards in parallel threads; the bit streams
    splice into one member on the host (``codec.continuous.BitSplicer``,
    the port's one splice). Across ranks each rank encodes its
    own shards and the streams are gathered before the splice.

    Where a shard that holds a stored block would splice at a bit offset
    that is not a multiple of 8, its stored blocks would be misaligned
    (the reference's stream is then invalid: fault F13); the splice encodes
    that shard again from the input at its true offset. The output is the
    reference's everywhere else.

    As in the reference, output made with a ``preset_dict`` may refer to
    dictionary bytes that a plain gzip reader does not have: only a
    dictionary-primed raw DEFLATE decoder reads it.
    """
    if not data:
        return native._EMPTY_MEMBER
    n = len(data)
    sh = lane_sharding(mesh, axis)
    D = sh.n
    blocks = -(-n // block_data)
    S = max(1, -(-blocks // D)) * block_data
    padded = np.zeros((D, S), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for d in range(D):
        seg = flat[d * S : (d + 1) * S]
        padded[d, : seg.size] = seg
    pd = broadcast_preset_dict(preset_dict, mesh) if preset_dict else None
    haloed = _halo_shards(padded, sh, pd)
    H = haloed[0].shape[1] - S  # the halo width carried (min(32 KiB, S))
    lens = [min(S, max(0, n - d * S)) for d in range(D)]
    dict_halo = min(H, len(preset_dict)) if preset_dict else 0
    last = max(d for d in range(D) if lens[d] > 0)
    rows = [h[0].cpu().numpy() for h in haloed]
    kw = dict(block_data=block_data, max_code_len=max_code_len, max_chain=max_chain)

    def encode(k: int) -> tuple[bytes, int, bool]:
        d = sh.first + k
        if lens[d] == 0:
            return b"", 0, False
        halo = min(H, d * S) if d > 0 else dict_halo
        buf = rows[k][H - halo : H + lens[d]].tobytes()
        return _deflate_shard(buf, halo, lens[d], d == last, **kw)

    with ThreadPoolExecutor(max_workers=min(len(rows), 8)) as ex:
        streams = list(ex.map(encode, range(len(rows))))
    sp = BitSplicer()
    for d, (sb, nbits, stored) in enumerate(_gather_streams(streams, sh)):
        r = sp.bitpos & 7
        if stored and r:  # F13: encode the shard again at its true offset
            halo = min(H, d * S)
            sb, nbits, _ = _deflate_shard(data[d * S - halo : d * S + lens[d]], halo, lens[d], d == last,
                                          start_bit=r, **kw)
            sp.append_aligned(sb, nbits - r)
        else:
            sp.append(sb, nbits)
    return build_member(sp.payload(), n, native.crc32(data))


# ---------------------------------------------------------------------------
# Sharded encode, resolve and decode steps
# ---------------------------------------------------------------------------


def sharded_analyze_emit(mesh: CodecMesh, axis="data", *, lazy: bool = True, quality: int = 0):
    """The encode step with the lane axis cut over the mesh (``axis`` a name
    or a tuple of names, e.g. ("host", "data") on a pod mesh).

    Returns fn(data (L, S) uint8, lengths (L,), ll_codes, d_codes,
    header_vals, header_bits, eob_val, eob_bits) -> (words (L, EMIT_WORDS)
    int32, total_bits (L,) int32) on the mesh's first device, L a multiple
    of the shard count: each shard runs the analysis (``encode.analyze``:
    the match finder, K8, the host walk, K9) and the emit with the given
    tables (``emit.emit_device``: header, K10's body and EOB in one launch,
    no routing) on its device. Every shard's phase 1 is
    launched before the first shard's transfer maps are pulled."""
    from ..codec import encode as pe
    from ..codec import parse as pp
    from ..codec.emit import emit_device

    sh = lane_sharding(mesh, axis)

    def step(data, lengths, *tables):
        shards = list(zip(*(sh.split(_tensor(a)) for a in (data, lengths, *tables))))
        p1s = [pe.analyze_phase1(d, l, lazy, quality) for d, l, *_t in shards]
        outs = []
        for (d, _l, *t), p1 in zip(shards, p1s):
            entries = torch.from_numpy(pp.host_entries(p1["transfers"].cpu().numpy())).to(d.device)
            a, flags = pe.analyze_phase2(d, p1["use"], p1["dist"], p1["tiles"], p1["valid"], entries)
            outs.append(emit_device(a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"],
                                    a["dist_eb"], a["dist_ev"], *t))
        return sh.gather([w for w, _b in outs]), sh.gather([b for _w, b in outs])

    return step


def sharded_resolve(mesh: CodecMesh, axis="data"):
    """The device LZ77 resolve with the lane axis cut over the mesh.

    Returns fn(tokens (L, N_POS) int32) -> (y (L, N_POS) int32, summary (L,
    8) int32 with the sweep's residue in row 3) on the mesh's first device,
    L a multiple of the shard count: each shard runs expand (K5) and sweep
    (K6) on its device (``resolve.resolve_tokens_device``), every shard
    launched before any result moves. Stream-start lanes only (no tail)."""
    from ..codec import resolve as rs

    sh = lane_sharding(mesh, axis)

    def fn(tokens):
        outs = [rs.resolve_tokens_device(t) for t in sh.split(_tensor(tokens))]
        return sh.gather([y for y, _s in outs]), sh.gather([s for _y, s in outs])

    return fn


def sharded_decode(mesh: CodecMesh, axis="data"):
    """The decode's wave runner over the mesh (``decode_v2.WaveRunner``):
    each wave's lanes cut over this process's shards of ``axis`` (None: all
    of the mesh's axes), with ``lane_multiple`` the shard count, so the
    host loop pads each wave to a multiple of it."""
    from ..codec.decode_v2 import WaveRunner

    return WaveRunner(lane_sharding(mesh.local(), axis))
