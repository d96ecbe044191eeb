"""Member-parallel gzip decode on a CUDA device (counterpart of
``tpu_deflate.codec.decode_jax_v2``).

The main path (:func:`_decode_single_block_device`) takes every member
whose payload is one final Huffman block of at most 64 KiB output: waves
go through the device stages :func:`wave_stages` (stage A (K1) -> stage B
(K2) -> stage C (``decode_kernels.stage_c``) -> stage DC (K3, whose
epilogue folds its summary rows into each lane's vector) -> level-2
compaction with the literal map (K4)), the tokens stay
on the device and resolve to bytes there (``resolve``: expand (K5), sweep
(K6)), the lane CRC-32 kernel checksums each row, and only the small
per-lane vectors and the final bytes cross to the host.

Every other Huffman member (several blocks, more than 64 KiB, or a lane
the main path hands back) walks its raw DEFLATE block chain on the host,
one block of each lane per wave through the same stages. On the device
route (:func:`_decode_chained_device`) each block's tokens stay on the
device, each lane's segments concatenate there, split into 64 KiB tiles
(``resolve.split_tiles_device``) and resolve and CRC in chained tiles with
32 KiB tails (``resolve.resolve_tiles_crc``); one byte pull per group of
lanes. Its batches hold members whose trailers claim at most
``BIG_BATCH_POSITIONS`` bytes together, which bounds its device memory; a
member claiming more is a batch of its own, and its lane resolves in
passes of at most that many bytes (:func:`_resolve_passes`: each pass
sliced from the lane's segments, split, resolved from the last 32 KiB of
the pass before and pulled, the CRC folded across the passes), so no
member leaves the device route because of its size. On the host route the
wave's compaction is K4's pull mode (``decode_kernels.compact_pack``: the
tokens split into literal bytes, matches and a bitmap, and each lane's
literal count in row 6 of K3's vector, in one launch), which brings each
block's tokens back packed; the shared C core resolves them and the host
checks the CRC; a lane the device route hands back (a stage error, a size
other than its ISIZE, a residue, an error position) takes it.

``device_resolve`` picks the routes: "auto" (the default) takes the main
path and the device route when the device is CUDA, and the host route
otherwise; "on" takes them on any device (the CPU tests); "off" takes the
host route for every Huffman member. The reference keeps its big members
on its host route under "auto", because its tokens reach the host anyway
and a re-upload over its link is pure loss; here the tokens never leave
the device, so "auto" keeps them there.

Every function takes an explicit ``device``; on a CPU device the kernels'
plain versions run (the CPU tests), on a CUDA device the kernels do.

With a mesh (``dist.mesh``), a :class:`WaveRunner` cuts each wave's lane
axis into the mesh's shards, contiguous in lane order and padded to a
multiple of their count, and each shard runs K1-K4 (K4's pull mode on the
host route, into the shard's own vector) on its own device; the main
path's rows resolve (K5, K6) and CRC on the device of the shard that
decoded them, and each batch of the device route
is cut into shards that resolve and CRC on their own devices (a lane in
passes resolves on the first shard's device). Every shard
is launched before the first pull to the host. The host loop, its wave
order and its error order are the single-device path's, which is the case
of one shard. Across ranks (a mesh whose host axis is the ranks) the
members split into one contiguous share a rank, which decodes its share
over its own devices; the bytes join in stream order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..dist.mesh import LaneSharding, pad_lanes
from ..format.errors import (
    DataFormatError,
    OutputCapacityError,
    Reason,
    check_device_error,
    reason_to_code,
)
from ..kernels import checksum_lanes as cl
from ..spans import span
from . import decode_kernels as dk
from .decode_kernels import compact_pack
from . import decode_np as dnp
from . import resolve as rs
from .wave_prep import (
    _ERR_END,
    _PAD_PAYLOAD,
    P_BUCKETS_PALLAS,
    V2_L_BUCKETS,
    V2_LANE_BATCH,
    W_P,
    WAVE_BYTES_CAP,
    _bucket,
    _k1_groups,
    _lane_k1,
    _prep_wave,
    _wave_arrays,
    wave_to_tensors,
)

W_CAP_INIT = 66560  # initial per-block window in bytes (covers any 64 KiB block)


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------


def stage_c_entries(
    transfers: torch.Tensor, entry0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compose the per-tile transfer maps over tiles.

    transfers (L, NT, 48) uint8 with values in [0, 48) or a sentinel
    (>= 127, passed through unchanged), as stage B produces them; entry0
    (L,) in [0, 48). Returns the entry offset of every tile (L, NT) uint8
    and the final state (L,) uint8: 127 (clean EOB), 255 (error) or an
    offset (ran off the payload). ``decode_kernels.stage_c``: one kernel
    launch on the card, ``stage_c_plain`` on the CPU.
    """
    entries, final, _entries32 = dk.stage_c(transfers, entry0.to(torch.int32))
    return entries, final


def wave_stages(w: dict, *, k1: int | None = None, pack: bool = False) -> tuple:
    """The device stages of one wave (``_run_wave_pallas_impl`` with its
    summary fold): stage A (K1), stage B (K2), stage C, stage DC (K3, the
    fold in its epilogue) and level-2 compaction (K4). ``w`` is a wave dict
    of tensors (:func:`wave_prep.wave_to_tensors`). Returns (tokens (L,
    NT*k1) int32 front-compacted with literal bytes mapped, K3's summary
    rows (L, 8, NT) int32, the (7, L) int32 vector the host pulls, with
    row 6 (nlit) 0), on the wave's device. With ``pack`` (the host route)
    the compaction is K4's pull mode (``decode_kernels.compact_pack``): the
    first result is then (bitmap, lit, match) of the compacted tokens, and
    row 6 of the vector holds each lane's literal count. ``k1`` defaults to
    the wave's bucket; past the largest bucket a tile can still overflow,
    and the wave loop then reruns the wave with k1 = 512, which cannot.
    """
    if k1 is None:
        k1 = _lane_k1(w.get("_min_tok_bits", 1))
    dt, tt = dk.stage_a(w["grid"], dk.build_meta(w))
    L, _W, NT = dt.shape
    transfers = dk.stage_b(dt)
    _entries, _final, entries = dk.stage_c(transfers, w["rem"])
    tokc, summ, small = dk.stage_dc(dt, tt, entries, k1=k1)
    del dt, tt, transfers, entries  # freed before the compaction's outputs are made
    if pack:
        bitmap, lit, match, _nlit = compact_pack(tokc.reshape(L, NT * k1), w["lit_planes"], small)
        return (bitmap, lit, match), summ, small
    tokens = dk.compact_flat(tokc.reshape(L, NT * k1), w["lit_planes"])
    return tokens, summ, small


def run_wave(w: dict, *, k1: int | None = None):
    """Device body of one wave (``_run_wave_pallas_impl``):
    :func:`wave_stages`. Returns the reference's 7-tuple (tokens, counts,
    has_eob, eob_exit, err_code, out_total, overflow), the per-lane fields
    rows of K3's (7, L) vector, all on the wave's device."""
    tokens, _summ, small = wave_stages(w, k1=k1)
    return tokens, small[0], small[1] > 0, small[2], small[3], small[4], small[5, 0] > 0


class WaveRunner:
    """The decode's lane axis cut over a ``dist.mesh.LaneSharding`` (the
    counterpart of the reference's ``sharded_decode`` runner): shard d of D
    takes lanes [d L / D, (d + 1) L / D) of L lanes, and a wave's L is
    padded to a multiple of D (``lane_multiple``). :meth:`on` is the
    single-device path, one shard. A device may repeat: its shards then run
    on it in turn. The front doors build one runner a call, and everything
    below them takes it."""

    def __init__(self, sharding: LaneSharding):
        self.sharding = sharding
        self.devices = sharding.devices
        self.lane_multiple = sharding.n

    @classmethod
    def on(cls, device: torch.device) -> "WaveRunner":
        return cls(LaneSharding.one(device))

    def lanes(self, n: int) -> int:
        """Lanes of a wave of n members: its lane bucket, padded to a
        multiple of the shards."""
        return pad_lanes(_bucket(n, V2_L_BUCKETS), self.lane_multiple)

    def shards(self, lanes: int, real: int) -> list[tuple[torch.device, int, int]]:
        """(device, first lane, end lane) of each shard of ``lanes`` (a
        multiple of ``lane_multiple``) that holds one of the first ``real``
        lanes, in lane order: a shard of padding lanes only does not run."""
        return [(dev, a, b) for dev, (a, b) in zip(self.devices, self.sharding.bounds(lanes, real))]

    def dispatch(self, w: dict, n: int) -> list[tuple[int, int, dict]]:
        """Upload the shards of wave ``w`` (NumPy, lanes leading) that hold
        one of its first n (real) lanes: (first lane, end lane, the shard's
        wave dict of tensors on its device), in lane order."""
        return [(a, b, wave_to_tensors({k: v if k.startswith("_") else v[a:b] for k, v in w.items()}, dev))
                for dev, a, b in self.shards(w["grid"].shape[0], n)]


# ---------------------------------------------------------------------------
# Host loop: block-chained decode of raw DEFLATE streams
# ---------------------------------------------------------------------------


@dataclass
class LaneState:
    """Decode progress of one raw DEFLATE stream."""

    payload: bytes
    bitpos: int = 0
    done: bool = False
    err: int = 0  # Reason code (reason_to_code), 0 = ok
    # The token stream's segments in stream order: np.int32 arrays (stored
    # blocks, and every block on the host route) and int32 tensors on the
    # decode device (Huffman blocks on the device route).
    tokens: list = field(default_factory=list)
    sizes: list = field(default_factory=list)  # output bytes of each segment the chain appended (for passes)
    out_total: int = 0
    window: int = W_CAP_INIT  # payload bytes per block on the device (grows on demand)
    bitpos_advanced: bool = False  # this wave's block reached its EOB
    # Device route: Huffman blocks' tokens stay on the device (no packed pull)
    # while out_total is at most this; None = host route.
    device_cap: int | None = None

    @property
    def bits(self) -> int:
        return len(self.payload) * 8


def _read_bits_host(payload: bytes, bitpos: int, n: int) -> int:
    """Little-endian LSB-first bit read (host, header peeks only)."""
    byte = bitpos >> 3
    chunk = int.from_bytes(payload[byte : byte + 8], "little")
    return (chunk >> (bitpos & 7)) & ((1 << n) - 1)


def _host_stored_block(st: LaneState, bfinal: bool) -> None:
    """Consume one stored block on the host."""
    bp = (st.bitpos + 3 + 7) & ~7  # header + align to byte
    if bp + 32 > st.bits:
        st.err = _ERR_END
        return
    byte = bp >> 3
    ln = int.from_bytes(st.payload[byte : byte + 2], "little")
    nlen = int.from_bytes(st.payload[byte + 2 : byte + 4], "little")
    if ln != (nlen ^ 0xFFFF):
        st.err = reason_to_code(Reason.UNCOMPRESSED_BLOCK_LENGTH_MISMATCH)
        return
    if bp + 32 + 8 * ln > st.bits:
        # partial data still counts as output before the END error
        avail = (st.bits - bp - 32) // 8
        if avail > 0:
            data = np.frombuffer(st.payload, np.uint8, avail, byte + 4).astype(np.int32)
            st.tokens.append(data)
            st.sizes.append(avail)
            st.out_total += avail
        st.err = _ERR_END
        return
    if ln:
        data = np.frombuffer(st.payload, np.uint8, ln, byte + 4).astype(np.int32)
        st.tokens.append(data)
        st.sizes.append(ln)
        st.out_total += ln
    st.bitpos = bp + 32 + 8 * ln
    if bfinal:
        st.done = True


def _advance_host(st: LaneState):
    """Walk stored blocks until a Huffman block (returns its (bfinal,
    btype)) or the lane is done or failed (returns None)."""
    while not (st.done or st.err):
        if st.bits - st.bitpos < 3:
            st.err = _ERR_END
            return None
        hdr = _read_bits_host(st.payload, st.bitpos, 3)
        bfinal, btype = hdr & 1, hdr >> 1
        if btype == 3:
            st.err = reason_to_code(Reason.RESERVED_BLOCK_TYPE)
            return None
        if btype == 0:
            _host_stored_block(st, bool(bfinal))
            continue
        return bfinal, btype
    return None


def decode_deflate_streams_v2(
    payloads: list[bytes],
    device=None,
    stats: dict | None = None,
    *,
    device_caps: list[int] | None = None,
    mesh=None,
) -> list[LaneState]:
    """Decode raw DEFLATE streams (any block chain) with the wave kernels
    on ``device``, or with each wave's lanes cut over ``mesh``
    (``dist.mesh.CodecMesh``; pass one of the two; across ranks, every rank
    walks every stream on its own devices).

    Returns one LaneState per stream with its token stream (stored-block
    bytes inlined as literal tokens, so the LZ77 window carries across
    blocks at resolve time), its exact output size and the Reason code of
    its first failure (0 = clean). With ``device_caps`` each Huffman
    block's tokens stay on ``device`` (a copy of the lane's row of the
    wave) while stream i's output is at most ``device_caps[i]``; a stream
    that passes its cap (longer than its trailer claims) has its tokens
    pulled to the host. Without, the packed pull (K4's pull mode) brings
    every block's tokens to the host. ``stats["waves"]``, when given,
    counts the device waves run.
    """
    return _decode_streams(payloads, _runner(device, mesh), stats, device_caps)


def _decode_streams(payloads: list[bytes], runner: WaveRunner, stats: dict | None,
                    device_caps: list[int] | None) -> list[LaneState]:
    """:func:`decode_deflate_streams_v2` on a runner."""
    assert len(payloads) <= V2_LANE_BATCH, "batch the lanes (V2_LANE_BATCH)"
    caps = [None] * len(payloads) if device_caps is None else device_caps
    lanes = [LaneState(p, device_cap=c) for p, c in zip(payloads, caps)]
    while True:
        wave = []  # (lane, bfinal) whose next block is Huffman
        with span("td.decode.prep"):
            for st in lanes:
                nxt = _advance_host(st)
                if nxt is not None:
                    wave.append((st, bool(nxt[0] & 1)))
        if not wave:
            break
        _decode_huffman_wave([st for st, _ in wave], runner, stats)
        for st, bfinal in wave:
            if not st.err and bfinal and st.bitpos_advanced:
                st.done = True
    return lanes


def _runner(device, mesh) -> WaveRunner:
    """The runner of a front door's ``device`` or ``mesh`` (one of them)."""
    if (device is None) == (mesh is None):
        raise ValueError("pass a device or a mesh")
    if mesh is None:
        return WaveRunner.on(device)
    from ..dist.sharded import sharded_decode

    return sharded_decode(mesh, None)


def _lane_cap(P: int, lane_multiple: int = 1) -> int:
    """Largest lane bucket whose padded wave stays under WAVE_BYTES_CAP
    (at least the shard count)."""
    cap = max(WAVE_BYTES_CAP // max(P, 1), lane_multiple, V2_L_BUCKETS[0])
    pick = V2_L_BUCKETS[0]
    for b in V2_L_BUCKETS:
        if b <= cap:
            pick = b
    return pick


def _decode_huffman_wave(wave: list[LaneState], runner: WaveRunner, stats) -> None:
    """Decode each lane's current Huffman block, grouped by padded-payload
    bucket and k1 (one oversized or short-code lane must not widen every
    other lane's arrays); groups split to stay under WAVE_BYTES_CAP. Every
    subwave is dispatched before any result is pulled, so host prep of one
    subwave overlaps the kernels of the one before."""
    if not wave:
        return
    with span("td.decode.prep"):
        for st in wave:
            st.bitpos_advanced = False
        k1s = _k1_groups([st.payload for st in wave], [st.bitpos for st in wave])
        groups: dict[tuple[int, int], list[LaneState]] = {}
        for st, k1 in zip(wave, k1s):
            avail = len(st.payload) - st.bitpos // 8
            key = (_bucket(max(min(avail, st.window), 1), P_BUCKETS_PALLAS), k1)
            groups.setdefault(key, []).append(st)
    pending = []
    for (P, _k1), grp in sorted(groups.items()):
        lmax = _lane_cap(P, runner.lane_multiple)
        for base in range(0, len(grp), lmax):
            pend = _decode_huffman_subwave(grp[base : base + lmax], P, runner, stats)
            if pend is not None:
                pending.append(pend)
    with span("td.decode.pull"):  # the wave's results read back and applied to its lanes
        for mid in [_apply_small(*pend) for pend in pending]:
            _apply_tokens(*mid)


def _decode_huffman_subwave(wave: list[LaneState], P: int, runner: WaveRunner, stats):
    """Dispatch one wave over lanes sharing payload bucket P; returns the
    pending (not yet pulled) results, or None if a header failed."""
    L_real = len(wave)
    L = runner.lanes(L_real)
    with span("td.decode.prep"):
        shifts = [st.bitpos // 8 for st in wave]
        rems = [st.bitpos % 8 for st in wave]
        avail = [len(st.payload) - sh for st, sh in zip(wave, shifts)]
        remain = [min(a, st.window, P) for a, st in zip(avail, wave)]
        rows = np.zeros((L, P), np.uint8)
        row_bits = np.zeros(L, np.int64)
        start_bits = np.zeros(L, np.int64)
        for i, st in enumerate(wave):
            rows[i, : remain[i]] = np.frombuffer(st.payload, np.uint8, remain[i], shifts[i])
            row_bits[i] = remain[i] * 8
            start_bits[i] = rems[i]
        for i in range(L_real, L):
            rows[i, : len(_PAD_PAYLOAD)] = np.frombuffer(_PAD_PAYLOAD, np.uint8)
            row_bits[i] = len(_PAD_PAYLOAD) * 8
        truncated = [remain[i] < avail[i] for i in range(L_real)]

        # Batched header parse; on failure re-parse lane by lane so the error
        # lands on the right stream only.
        try:
            hp = dnp.parse_headers_batch(rows, row_bits, start_bits=start_bits)
        except DataFormatError:
            hp = None
            for i, st in enumerate(wave):
                r = _reparse_single(rows[i : i + 1], row_bits[i : i + 1], start_bits[i : i + 1])
                if r is not None:
                    st.err = reason_to_code(r)
    if hp is None:
        rest = [st for st in wave if not st.err]
        if len(rest) < len(wave):
            _decode_huffman_wave(rest, runner, stats)
        return None
    return _dispatch_block_stages(wave, rows, row_bits, hp, truncated, runner, stats)


def _reparse_single(rows, row_bits, start_bits):
    try:
        dnp.parse_headers_batch(rows, row_bits, start_bits=start_bits)
        return None
    except DataFormatError as e:
        return e.reason


def _dispatch_block_stages(wave, rows, row_bits, hp, truncated, runner: WaveRunner, stats):
    """Launch one wave's device work, shard by shard; nothing is pulled to
    the host here. The pending shards are (wave dict, tokens, small)."""
    with span("td.decode.prep"):
        w_np, shift2 = _wave_arrays(rows, row_bits, hp)
    on_device = wave[0].device_cap is not None  # one route for every lane of a chain batch
    shards = []
    with span("td.decode.enqueue"):
        for _a, _b, w in runner.dispatch(w_np, len(wave)):
            if on_device:
                tokens, _summ, small = wave_stages(w)
                shards.append((w, ("device", tokens), small))
            else:
                packed, _summ, small = wave_stages(w, pack=True)
                shards.append((w, ("packed", *packed), small))
    if stats is not None:
        stats["waves"] = stats.get("waves", 0) + 1
    return wave, shift2, truncated, shards


def _round_cols(k: int, width: int, bucket: int) -> int:
    """Round a column request up to the pull bucket (0 stays 0)."""
    return min(width, -(-k // bucket) * bucket)


def _pull(tensors, cols: int) -> np.ndarray:
    """The first ``cols`` columns of each shard's tensor, on the host, the
    shards' rows one after another."""
    parts = [t[:, :cols].cpu().numpy() for t in tensors]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _apply_small(wave, shift2, truncated, shards):
    """Pull a wave's per-lane results, then only the token columns in use
    (none where the tokens stay on the device). The token payload is
    ("device", the shards' tokens), ("raw", tokens) or ("packed", bitmap,
    literals, matches), the host arrays with a row per lane."""
    small_h = np.concatenate([small.cpu().numpy() for _w, _p, small in shards], axis=1)
    n = len(wave)
    on_device = shards[0][1][0] == "device"
    if small_h[5].any():
        # Some tile held more than k1 tokens (degenerate short-code
        # stream): rerun the wave with k1 = 512, which cannot overflow,
        # and take the raw token array.
        reruns = [wave_stages(w, k1=W_P) for w, _p, _s in shards]
        small_h = np.concatenate([small.cpu().numpy() for _t, _summ, small in reruns], axis=1)
        tokens = [t for t, _summ, _small in reruns]
        if on_device:
            return wave, shift2, truncated, ("device", tokens), small_h
        kmax = int(small_h[0, :n].max()) if wave else 0
        k = _round_cols(max(kmax, 1), tokens[0].shape[1], 4096)
        return wave, shift2, truncated, ("raw", _pull(tokens, k)), small_h
    if on_device:
        return wave, shift2, truncated, ("device", [p[1] for _w, p, _s in shards]), small_h
    bitmap, lit8, match32 = shards[0][1][1:]
    counts = small_h[0, :n]
    nlit = small_h[6, :n]
    kmax = int(counts.max()) if n else 0
    lk = _round_cols(int(nlit.max()) if n else 0, lit8.shape[1], 2048)
    mk = _round_cols(int((counts - nlit).max()) if n else 0, match32.shape[1], 2048)
    bk = _round_cols(-(-max(kmax, 1) // 32), bitmap.shape[1], 512)
    pulled = (
        "packed",
        _pull([p[1] for _w, p, _s in shards], bk).view(np.uint32),
        _pull([p[2] for _w, p, _s in shards], lk),
        _pull([p[3] for _w, p, _s in shards], mk),
    )
    return wave, shift2, truncated, pulled, small_h


def _lane_tokens(payload, small_h, i: int, count: int) -> np.ndarray:
    """Rebuild lane i's int32 token stream from the pulled arrays."""
    if payload[0] == "raw":
        return payload[1][i, :count]
    bm, lit8, match32 = payload[1:]
    nl = int(small_h[6, i])
    words = bm[i, : -(-count // 32)]
    bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool).ravel()[:count]
    tok = np.empty(count, np.int32)
    tok[bits] = lit8[i, :nl].astype(np.int32)
    tok[~bits] = match32[i, : count - nl]
    return tok


def _device_segments(tokens: torch.Tensor, take: np.ndarray) -> list:
    """Row i's first take[i] tokens of a wave's (L, M) tokens, as views of
    one compact copy on the tokens' device (so the wave tensor is freed),
    or None where take[i] is 0."""
    n = len(take)
    want = torch.from_numpy(take).to(tokens.device)
    mask = torch.arange(tokens.shape[1], device=tokens.device).view(1, -1) < want.view(n, 1)
    flat = tokens[:n][mask]
    parts = iter(flat.split([int(c) for c in take if c]))
    return [next(parts) if c else None for c in take]


def _apply_tokens(wave, shift2, truncated, payload, small_h) -> None:
    counts_h, has_eob_h, eob_exit_h, err_h, total_h = small_h[:5]
    take = np.zeros(len(wave), np.int64)
    for i, st in enumerate(wave):
        # A window-truncated row can only produce a spurious
        # UNEXPECTED_END or a missing EOB: grow the window and redo the
        # block. Any other error, or an EOB, is genuine.
        if truncated[i] and not has_eob_h[i] and err_h[i] in (0, _ERR_END):
            st.window *= 4
            continue
        if counts_h[i]:
            take[i] = counts_h[i]
            st.sizes.append(int(total_h[i]))
            st.out_total += int(total_h[i])
        if err_h[i]:
            st.err = int(err_h[i])
        elif has_eob_h[i]:
            # global bit position just past this block's EOB symbol
            st.bitpos = (st.bitpos // 8 + int(shift2[i])) * 8 + int(eob_exit_h[i])
            st.bitpos_advanced = True
        else:
            st.err = _ERR_END  # ran off the payload without reaching EOB
    if payload[0] != "device":
        for i, st in enumerate(wave):
            if take[i]:
                st.tokens.append(_lane_tokens(payload, small_h, i, int(take[i])))
        return
    segs = []
    for tokens in payload[1]:  # each shard's lanes, in lane order
        part = take[len(segs) : len(segs) + tokens.shape[0]]
        segs += _device_segments(tokens, part) if part.any() else [None] * len(part)
    for st, seg in zip(wave, segs):
        if seg is not None:
            st.tokens.append(seg)
        if st.out_total > st.device_cap:  # past its trailer's size: no longer held on the device
            st.tokens = [s.cpu().numpy() if isinstance(s, torch.Tensor) else s for s in st.tokens]


# ---------------------------------------------------------------------------
# Host resolve + container
# ---------------------------------------------------------------------------


def _df(reason: Reason) -> DataFormatError:
    return DataFormatError(reason, reason.name)


def _resolve_lane(st: LaneState, cap: int | None) -> bytes:
    """Expand a lane's tokens to bytes on the host, in reference error
    order: a bad back-reference comes earlier in the stream than any
    pending stage error, so resolve runs first and the stage error is
    raised only if resolution succeeds."""
    parts = [s.cpu().numpy() if isinstance(s, torch.Tensor) else s for s in st.tokens]
    tokens = (np.concatenate(parts) if parts else np.zeros(0, np.int32)).astype(np.int32)
    want = cap if (cap is not None and not st.err) else st.out_total + 1
    try:
        out = native.resolve_tokens(tokens, max(want, 1))
    except OutputCapacityError:
        raise _df(Reason.DECOMPRESSED_SIZE_MISMATCH) from None
    if st.err:
        check_device_error(st.err)
    return out


def inflate_raw_v2(payload: bytes, *, device: torch.device) -> bytes:
    """Decode one complete raw DEFLATE stream through the wave kernels;
    raises DataFormatError with the reference taxonomy."""
    return inflate_raw_end_v2(payload, device=device)[0]


def inflate_raw_end_v2(payload: bytes, *, device: torch.device) -> tuple[bytes, int]:
    """:func:`inflate_raw_v2`, and the payload bytes the stream took (to its
    final block's end, rounded up to a byte): where a container's trailer
    begins."""
    with span("td.decode"):
        st = decode_deflate_streams_v2([payload], device)[0]
        with span("td.decode.assemble"):
            return _resolve_lane(st, None), (st.bitpos + 7) // 8


# ---------------------------------------------------------------------------
# Device resolve of single-block members (the main path)
# ---------------------------------------------------------------------------

RB = 256  # lanes per resolve batch (the last batch holds the rest, unpadded)


def _single_block_eligible(buf: np.ndarray, m: dnp.MemberIndex) -> bool:
    """A member the main path decodes whole: one final Huffman block whose
    output fits a resolve tile and whose payload fits a bucket."""
    if m.isize > rs.N_POS:
        return False
    plen = m.end - 8 - m.payload_start
    if plen <= 0 or plen > P_BUCKETS_PALLAS[-1]:
        return False
    hdr = int(buf[m.payload_start])
    return (hdr & 1) == 1 and ((hdr >> 1) & 3) in (1, 2)


def _single_block_shards(payloads: list[bytes], runner: WaveRunner, stats: dict | None):
    """The main path's waves: payloads grouped by payload bucket and k1,
    each group's waves through :func:`wave_stages` (the summary fold in K3),
    shard by shard. Returns (the payload index of each row, rows in wave
    order, and per shard that ran (the positions of its rows in that order,
    the per-lane vectors (7, n) int32 of K3's summary fold, the tokens (n, N_POS) int32 padded or
    cut to N_POS slots), on the shard's device)."""
    N = rs.N_POS
    with span("td.decode.prep"):
        k1s = _k1_groups(payloads, [0] * len(payloads))
        bygroup: dict[tuple[int, int], list[int]] = {}
        for i, (p, k1) in enumerate(zip(payloads, k1s)):
            bygroup.setdefault((_bucket(len(p), P_BUCKETS_PALLAS), k1), []).append(i)
    order: list[int] = []
    shards: dict[int, tuple[list, list, list]] = {}
    for (P, _k1), idxs in sorted(bygroup.items()):
        lmax = _lane_cap(P, runner.lane_multiple)
        for base in range(0, len(idxs), lmax):
            chunk = idxs[base : base + lmax]
            with span("td.decode.prep"):
                w = _prep_wave([payloads[i] for i in chunk], runner.lanes(len(chunk)))
            with span("td.decode.enqueue"):
                for d, (a, b, wt) in enumerate(runner.dispatch(w, len(chunk))):
                    tokens, _summ, small = wave_stages(wt)
                    n = min(b, len(chunk)) - a
                    t = tokens[:n, :N]
                    rows, smalls, toks = shards.setdefault(d, ([], [], []))
                    rows += range(len(order) + a, len(order) + a + n)
                    toks.append(torch.nn.functional.pad(t, (0, N - t.shape[1]), value=-1))
                    smalls.append(small[:, :n])
            if stats is not None:
                stats["waves"] = stats.get("waves", 0) + 1
            order += chunk
    with span("td.decode.enqueue"):
        return order, [(rows, torch.cat(smalls, 1), torch.cat(toks)) for rows, smalls, toks in shards.values()]


def single_block_tokens(
    payloads: list[bytes], device: torch.device, stats: dict | None = None
) -> tuple[list[int], torch.Tensor, torch.Tensor]:
    """The main path's waves on one device: (the payload index of each
    row, the per-lane vectors (7, n) int32 of K3's summary fold, the
    tokens (n, N_POS) int32 padded or cut to N_POS slots), rows in wave
    order and all on ``device``. ``payloads`` must not be empty."""
    order, ((_rows, small, T),) = _single_block_shards(payloads, WaveRunner.on(device), stats)
    return order, small, T


def _decode_single_block_device(
    payloads: list[bytes], members: list, verify_crc: bool, runner: WaveRunner, stats: dict
) -> list[bytes | None]:
    """Decode single-block final Huffman members entirely on the runner's
    devices.

    Each shard's rows of the waves (:func:`_single_block_shards`) resolve on
    its device in batches of at most RB lanes (K5, K6) and the lane CRC
    kernel checksums them; every shard is launched before the first pull.
    The host pulls the per-lane vectors, summaries and raw CRCs first, the
    bytes after. Returns per member its bytes, or None where the lane goes
    back to the host route (a wave shard whose tiles overflowed k1, or a
    resolve residue). Walks the rows in wave order and raises
    DataFormatError in the reference's order: copy-before-start, then the
    stage error, then a missing EOB, then size, then CRC.
    """
    N = rs.N_POS
    order, shards = _single_block_shards(payloads, runner, stats)
    launched = []
    with span("td.decode.enqueue"):
        for rows, small, T in shards:
            ys, summs, raws = [], [], []
            for base in range(0, T.shape[0], RB):
                y, summ = rs.resolve_tokens_device(T[base : base + RB])
                y8 = y.to(torch.uint8)
                ys.append(y8)
                summs.append(summ)
                raws.append(cl.crc32_lanes_raw8(y8))
            launched.append((rows, small, ys, summs, raws))
    where: list = [None] * len(order)  # row -> (shard, its row there)
    small_h, summ_h, crcs = [], [], []
    for k, (rows, small, _ys, summs, raws) in enumerate(launched):
        with span("td.decode.pull"):
            small_h.append(small.cpu().numpy())
            summ_h.append(torch.cat(summs).cpu().numpy())
            raw_h = torch.cat(raws).cpu().numpy()
        with span("td.decode.assemble"):
            crcs.append(cl.crc32_finish_leftaligned(raw_h, np.clip(summ_h[k][:, 1], 0, N), N)
                        if verify_crc else None)
            for r, g in enumerate(rows):
                where[g] = (k, r)
    with span("td.decode.pull"):
        y_h = [torch.cat(ys).cpu().numpy() for _rows, _small, ys, _summs, _raws in launched]

    outs: list[bytes | None] = [None] * len(payloads)
    with span("td.decode.assemble"):
        for li, pi in enumerate(order):
            k, r = where[li]
            _count, has_eob, _eob_exit, err, _total, ovf, _nlit = (int(v) for v in small_h[k][:, r])
            if ovf:
                continue  # a tile held more than k1 tokens: the host route redoes it
            summ = summ_h[k][r]
            if int(summ[0]) < N:
                # a bad back-reference precedes any pending stage error
                raise _df(Reason.COPY_FROM_BEFORE_DICTIONARY_START)
            if err:
                check_device_error(err)
            if not has_eob:
                check_device_error(_ERR_END)
            if int(summ[3]) > 0:
                continue  # unresolved residue: the host route resolves the lane
            total = int(summ[1])
            m = members[pi]
            if total != m.isize:
                raise _df(Reason.DECOMPRESSED_SIZE_MISMATCH)
            if verify_crc and int(crcs[k][r]) != m.crc32:
                raise _df(Reason.DECOMPRESSED_CHECKSUM_MISMATCH)
            outs[pi] = y_h[k][r, :total].tobytes()
    return outs


# ---------------------------------------------------------------------------
# Device resolve of every other Huffman member: chained tiles
# ---------------------------------------------------------------------------

BIG_BATCH_POSITIONS = 1 << 26
"""Output bytes (positions) that the members of one block-chain batch on
the device route may claim together in their trailers (ISIZE). Members are
batched in stream order under it, and it bounds what the route holds on the
device at a time: a batch's tokens (int32, at most one a position), their
padded copy, the tile split's scratch (8 bytes a 4096 tokens, 12 bytes a
tile) and the tiles (4 bytes a position) with their byte buffer (1). A member that claims more (more than 64 MiB of output) is a
batch of its own and resolves in passes of at most this many bytes
(BIG_BATCH_POSITIONS // N_POS = 1024 tiles, :func:`_resolve_passes`), so
one pass holds no more on the device than a batch at the bound: no member
leaves the device route because of its size. A lane whose output passes
its own ISIZE during the block chain has its tokens pulled to the host (it
fails the size check there). ISIZE is the size modulo 2**32, so a member of
4 GiB or more fails its size check on every route, the reference's
included: such members are out of scope."""


def _chain_batches(huff: list, batch_n: int, on_device: bool):
    """Consecutive runs of ``huff``'s (index, member) pairs for the block-
    chain driver, in stream order: at most ``batch_n`` members a run; with
    ``on_device`` (the device route) members claiming at most
    BIG_BATCH_POSITIONS bytes together, and a member claiming more alone."""
    batch, claimed = [], 0
    for im in huff:
        isize = im[1].isize
        if batch and (len(batch) == batch_n or (on_device and claimed + isize > BIG_BATCH_POSITIONS)):
            yield batch
            batch, claimed = [], 0
        batch.append(im)
        claimed += isize
    if batch:
        yield batch


def _decode_chained_device(
    states: list[LaneState], isizes: list[int], verify_crc: bool, runner: WaveRunner, stats: dict
) -> list[tuple[bytes, int | None] | None]:
    """Resolve and CRC the lanes of one device-route batch on the runner's
    devices.

    Each lane that finished with no stage error and exactly its trailer's
    size (``isizes``; the host route fails any other, and stops resolving
    at the ISIZE) has tile count T = ceil(out_total / N_POS). A lane of
    more than BIG_BATCH_POSITIONS // N_POS tiles resolves in passes of that
    many tiles on the first shard's device (:func:`_resolve_passes`). The others group by T and each group
    is cut into contiguous shards, one a device; each lane's token segments
    concatenate on its shard's device, and each shard runs the tile split
    (:func:`resolve.split_tiles_device`), T chained steps of K5, K6 and the
    lane CRC (:func:`resolve.resolve_tiles_crc`); every shard of the group
    is launched before its first pull. Then the host folds each lane's CRC
    from its T raw registers. The summaries and registers come to the host
    first, the bytes after.
    Returns per lane (its bytes, its CRC-32 or None without
    ``verify_crc``), or None where the lane takes the host route: a stage
    error, no tokens, another size, a residue or an error position in any
    tile (the reference's reasons, and the size)."""
    N = rs.N_POS
    outs: list = [None] * len(states)
    bygroup: dict[int, list[int]] = {}
    for j, st in enumerate(states):
        if not (st.err or not st.tokens or st.out_total != isizes[j]):
            bygroup.setdefault(-(-st.out_total // N), []).append(j)
    first_device = runner.shards(pad_lanes(1, runner.lane_multiple), 1)[0][0]
    pass_tiles = max(BIG_BATCH_POSITIONS // N, 1)
    for T, grp in sorted(bygroup.items()):
        if T > pass_tiles:
            for j in grp:
                outs[j] = _resolve_passes(states[j], verify_crc, first_device, pass_tiles, stats)
            continue
        launched = []
        with span("td.decode.enqueue"):
            for dev, a, b in runner.shards(pad_lanes(len(grp), runner.lane_multiple), len(grp)):
                part = grp[a:b]
                for j in part:
                    segs = [t.to(dev) if isinstance(t, torch.Tensor) else torch.from_numpy(t).to(dev)
                            for t in states[j].tokens]
                    states[j].tokens = [torch.cat(segs) if len(segs) > 1 else segs[0]]
                tok = torch.nn.utils.rnn.pad_sequence([states[j].tokens[0] for j in part], batch_first=True,
                                                      padding_value=-1)
                launched.append((part, *rs.resolve_tiles_crc(rs.split_tiles_device(tok, T))))
                del tok
        stats["chained_groups"] = stats.get("chained_groups", 0) + 1
        stats["chained_tiles"] = stats.get("chained_tiles", 0) + len(grp) * T
        for part, y8, summs, raws in launched:
            with span("td.decode.pull"):
                summ_h, raw_h = summs.cpu().numpy(), raws.cpu().numpy()
            with span("td.decode.assemble"):
                totals = np.array([states[j].out_total for j in part], np.int64)
                crcs = cl.crc32_fold_tiles(raw_h, totals, N) if verify_crc else None
                ok = (summ_h[:, :, 3].sum(1) == 0) & (summ_h[:, :, 0] >= N).all(1)
            if not ok.any():
                continue
            with span("td.decode.pull"):
                y_h = y8.cpu().numpy()
            with span("td.decode.assemble"):
                for r, j in enumerate(part):
                    if ok[r]:
                        outs[j] = (y_h[r, : totals[r]].tobytes(), None if crcs is None else int(crcs[r]))
                        states[j].tokens = []
    return outs


def _token_runs(tokens: torch.Tensor) -> torch.Tensor:
    """Output bytes of each token (int64): a match's run, 1 for a literal."""
    x = tokens.to(torch.int64)
    return torch.where((x & rs.TOKEN_MATCH_BIT) != 0, (x >> 16) & 0x3FF, 1)


def _covering_token(seg: torch.Tensor, i: int, s: int, x: int, chunk: int) -> tuple[int, int]:
    """(j, its start): the token of ``seg`` whose output covers offset x of
    the lane, found from token i, which starts at s <= x. The run lengths'
    cumulative sum runs over chunks of at most ``chunk`` tokens."""
    while True:
        part = seg[i : i + chunk]
        if not part.numel():
            raise RuntimeError("a token segment holds fewer output bytes than its wave counted")
        ends = s + _token_runs(part).cumsum(0)
        j = int((ends <= x).sum())
        if j < part.numel():
            return i + j, s if j == 0 else int(ends[j - 1])
        i, s = i + part.numel(), int(ends[-1])


def _resolve_passes(st: LaneState, verify_crc: bool, dev: torch.device, pass_tiles: int, stats: dict):
    """Resolve and CRC one lane of more than ``pass_tiles`` tiles on
    ``dev``, in passes: pass p covers output bytes [p B, min((p + 1) B,
    out_total)) with B = pass_tiles N_POS. Its tokens are the second half of the match
    straddling in from pass p - 1, if any (run ``end - p B``, the same
    distance, as the tile split cuts a match at every seam), then the
    lane's tokens that start inside the pass, sliced from the lane's
    segments, which stay as they are until the lane is done. Each pass
    splits into its tiles on ``dev`` (:func:`resolve.split_tiles_device`;
    positions relative to the pass, so none passes int32) and resolves and
    CRCs them in chained steps (:func:`resolve.resolve_tiles_crc`), pass 0
    from the stream's start and every later pass from the last 32 KiB of
    the pass before; its bytes, summaries and raw CRC registers come to the
    host, and the CRC folds over every tile of the lane after the last
    pass. Each seam is found from the segments' output sizes
    (``st.sizes``) and a cumulative sum over the one segment that holds it
    (:func:`_covering_token`), resumed from the seam before.

    Returns (the lane's bytes, its CRC-32 or None without ``verify_crc``),
    or None where a pass holds a residue or an error position: the lane
    then takes the host route with its segments kept."""
    N = rs.N_POS
    B = pass_tiles * N
    total = st.out_total
    segs = [t if isinstance(t, torch.Tensor) else torch.from_numpy(t) for t in st.tokens]
    seg_ends = np.cumsum(st.sizes)
    out = np.empty(total, np.uint8)
    raws, tail = [], None
    k, i, s = 0, 0, 0  # the token covering the pass's first byte: segment k, token i, its start s
    for x0 in range(0, total, B):
        x1 = min(x0 + B, total)
        pieces = []
        with span("td.decode.prep"):  # the pass's tokens: the seams' searches read the segments on the device
            if s < x0:  # a match straddles the seam: its second half heads the pass
                v = int(segs[k][i])
                end = s + ((v >> 16) & 0x3FF)
                pieces.append(torch.tensor([rs.TOKEN_MATCH_BIT | (end - x0) << 16 | (v & 0xFFFF)],
                                           dtype=torch.int32))
                i, s = i + 1, end
            if x1 < total:
                k1 = int(np.searchsorted(seg_ends, x1, side="right"))
                a, sa = (i, s) if k1 == k else (0, int(seg_ends[k1 - 1]))  # from the first token not yet taken
                i1, s1 = _covering_token(segs[k1], a, sa, x1, B)
                stop = i1 + (s1 < x1)  # the straddler's first half ends the pass
            else:
                k1, i1, s1 = len(segs) - 1, 0, total
                stop = segs[-1].numel()
            for kk in range(k, k1 + 1):
                piece = segs[kk][i if kk == k else 0 : stop if kk == k1 else None]
                if piece.numel():
                    pieces.append(piece)
        with span("td.decode.enqueue"):
            tokens = torch.cat([p.to(dev) for p in pieces])[None]
            del pieces
            T = -(-(x1 - x0) // N)
            y8, summs, raw = rs.resolve_tiles_crc(rs.split_tiles_device(tokens, T), tail=tail)
            del tokens
        stats["passes"] = stats.get("passes", 0) + 1
        stats["chained_groups"] = stats.get("chained_groups", 0) + 1
        stats["chained_tiles"] = stats.get("chained_tiles", 0) + T
        with span("td.decode.pull"):
            summ_h = summs.cpu().numpy()
            if summ_h[0, :, 3].sum() or (summ_h[0, :, 0] < N).any():
                return None
            raws.append(raw.cpu().numpy())
            out[x0:x1] = y8[0, : x1 - x0].cpu().numpy()
        with span("td.decode.enqueue"):
            tail = y8[:, -rs.TAIL :].to(torch.int32)
        k, i, s = k1, i1, s1
    with span("td.decode.assemble"):
        crc = int(cl.crc32_fold_tiles(np.concatenate(raws, axis=1), np.array([total]), N)[0]) if verify_crc else None
    st.tokens, st.sizes = [], []
    return out.tobytes(), crc


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

# Routing and launch record of the last gzip_decompress_v2 call: members,
# stored, device_resolved, host_resolved, waves, launches (kernel launches
# during the call); on the device route chained_groups (tile splits: a
# group of lanes, or one pass), chained_tiles (the tiles of every group and
# pass) and passes (passes over lanes above BIG_BATCH_POSITIONS); empty
# after a stream without a member index. Module state shared by every
# caller; not thread-safe.
LAST_DECODE_STATS: dict = {}


def gzip_decompress_v2(
    data: bytes,
    *,
    device: torch.device | None = None,
    mesh=None,
    verify_crc: bool = True,
    lane_batch: int | None = None,
    device_resolve: str = "auto",
) -> bytes:
    """Member-parallel gzip decode with the kernels on ``device``, or with
    the lane axis of every device stage cut over ``mesh``
    (``dist.mesh.CodecMesh``; pass one of the two).

    Stored members decode on the host. ``device_resolve``: "auto" sends
    every single-block Huffman member of at most 64 KiB through the main
    path and every other Huffman member through the device route (tokens
    kept on the device, chained 64 KiB tiles, CRC on the device) when
    ``device`` is CUDA, and everything through the host route otherwise;
    "on" does the same on any device; "off" takes the host route (packed
    token pull, C-core resolve, host CRC) for every Huffman member. Unlike
    the reference, "auto" sends big and multi-block members to the device,
    since their tokens are already there. No member leaves the device route
    because of its size: one whose trailer claims more than
    BIG_BATCH_POSITIONS bytes (64 MiB) resolves alone, in passes of at most
    that many bytes. ISIZE is the size modulo 2**32, so a member of 4 GiB
    or more fails its size check on every route, the reference's included.
    ``lane_batch`` caps members per block-chain batch (at most
    V2_LANE_BATCH). A stream without the TD member index decodes member by
    member in the shared C core.

    With a mesh, each wave's lanes, each main-path resolve and each
    device-route batch are cut into the mesh's shards (:class:`WaveRunner`);
    the output and the Reason of a failure are the single-device path's,
    and so are the routes: every Huffman member that the device would
    resolve alone resolves on its shard (the reference's mesh path resolves
    every member on the host). A mesh across ranks splits the members into
    one share a rank (:func:`_decompress_across_ranks`).
    """
    if device_resolve not in ("auto", "on", "off"):
        raise ValueError(f"device_resolve={device_resolve!r}: expected 'auto', 'off' or 'on'")
    runner = _runner(device, mesh)
    with span("td.decode"):  # its own time: the member split and the route choice
        if mesh is not None and mesh.rank_axis is not None:
            return _decompress_across_ranks(data, mesh, verify_crc=verify_crc, lane_batch=lane_batch,
                                            device_resolve=device_resolve)
        device = runner.devices[0]
        stats = LAST_DECODE_STATS
        stats.clear()
        buf = np.frombuffer(data, dtype=np.uint8)
        members = dnp.split_members(buf)
        if not members:
            with span("td.decode.assemble"):
                return native.gzip_decompress_serial(data)

        out_parts: list[bytes | None] = [None] * len(members)
        stored: list[tuple[int, dnp.MemberIndex]] = []
        huff: list[tuple[int, dnp.MemberIndex]] = []
        for i, m in enumerate(members):
            btype = (int(buf[m.payload_start]) >> 1) & 3 if m.payload_start < buf.size else 0
            (stored if btype == 0 else huff).append((i, m))
        with span("td.decode.assemble"):
            for i, m in stored:
                out_parts[i] = dnp._decode_stored_member(buf, m, verify_crc=verify_crc).tobytes()

        stats.update(members=len(members), stored=len(stored), waves=0)
        launches0 = dict(dk.LAUNCHES)
        device_resolved = 0
        on_device = device_resolve == "on" or (device_resolve == "auto" and device.type == "cuda")
        if huff and on_device:
            elig = [(i, m) for i, m in huff if _single_block_eligible(buf, m)]
            if elig:
                with span("td.decode.prep"):
                    payloads = [buf[m.payload_start : m.end - 8].tobytes() for _, m in elig]
                outs = _decode_single_block_device(payloads, [m for _, m in elig], verify_crc, runner, stats)
                done = set()
                for (i, _m), o in zip(elig, outs):
                    if o is not None:
                        out_parts[i] = o
                        done.add(i)
                huff = [(i, m) for i, m in huff if i not in done]
                device_resolved = len(done)

        # The other members (multi-block, larger than 64 KiB, handed back)
        # walk their block chains through the wave kernels; on the device
        # route their tokens stay on the device, tile-split and resolve with
        # chained 32 KiB tails, CRC included.
        batch_n = min(lane_batch or V2_LANE_BATCH, V2_LANE_BATCH)
        for batch in _chain_batches(huff, batch_n, on_device):
            with span("td.decode.prep"):
                payloads = [buf[m.payload_start : m.end - 8].tobytes() for _, m in batch]
            isizes = [m.isize for _, m in batch] if on_device else None
            states = _decode_streams(payloads, runner, stats, isizes)
            douts = (_decode_chained_device(states, isizes, verify_crc, runner, stats) if on_device
                     else [None] * len(batch))
            with span("td.decode.assemble"):  # the host route's resolve, and every member's checks
                for j, ((i, m), st) in enumerate(zip(batch, states)):
                    out, crc = douts[j] if douts[j] is not None else (_resolve_lane(st, m.isize), None)
                    if len(out) != m.isize:
                        raise _df(Reason.DECOMPRESSED_SIZE_MISMATCH)
                    if verify_crc and (native.crc32(out) if crc is None else crc) != m.crc32:
                        raise _df(Reason.DECOMPRESSED_CHECKSUM_MISMATCH)
                    out_parts[i] = out
            device_resolved += sum(o is not None for o in douts)
        stats["device_resolved"] = device_resolved
        stats["host_resolved"] = len(members) - stats["stored"] - device_resolved
        stats["launches"] = {k: dk.LAUNCHES[k] - launches0[k] for k in dk.LAUNCHES}
        with span("td.decode.assemble"):
            return b"".join(p for p in out_parts if p is not None)


def _decompress_across_ranks(data: bytes, mesh, **kw) -> bytes:
    """:func:`gzip_decompress_v2` over a mesh whose host axis is the ranks.

    Members are independent, so rank r of W decodes the members [r M / W,
    (r + 1) M / W) of the TD index (one contiguous share of the stream) over
    its own devices, and every rank gets the whole output in stream order
    (``dist.sharded.rank_results``). If a share fails, every rank raises:
    the Reason of the first rank whose share failed, which is the Reason of
    the one-process decode when one member is at fault, or, where that
    rank's failure is not a data format error, an error naming the rank
    (that rank raises its own).
    ``LAST_DECODE_STATS`` then describes this rank's share. A stream
    without the member index decodes whole on every rank."""
    from ..dist.sharded import rank_results

    members = dnp.split_members(np.frombuffer(data, dtype=np.uint8))
    if not members:
        return native.gzip_decompress_serial(data)
    W, r = mesh.world, mesh.rank
    share = members[r * len(members) // W : (r + 1) * len(members) // W]
    out, failure = b"", None
    if share:
        try:
            out = gzip_decompress_v2(data[share[0].start : share[-1].end], mesh=mesh.local(), **kw)
        except Exception as e:  # every rank must reach the collective, or the others wait in it
            failure = e
    return rank_results(out, failure, mesh)
