"""Host-side wave preparation for the decode kernels (NumPy only).

A copy of the NumPy host prep of ``tpu_deflate.codec.decode_jax_v2`` and
the layout constants of ``tpu_deflate.codec.decode_pallas``: the port
imports nothing of the JAX package. Everything here is kept identical
to the reference (``tests/test_torch_wave_prep.py`` holds it key by key),
so both packages cut waves into the same shapes and tables. The payload
and lane buckets (``P_BUCKETS_PALLAS``, ``V2_L_BUCKETS``,
``WAVE_BYTES_CAP``) exist in the reference because XLA compiles once per
shape; they are kept for parity until a measurement on the card says
whether to drop them.

:func:`wave_to_tensors` is the only addition: it carries a wave dict
(NumPy arrays) over to the port's tensors on a given device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.errors import Reason, reason_to_code
from ..format.tables import LENGTH_BASE, LENGTH_EXTRA
from . import decode_np as dnp

W_TILE_P = 512  # stage A layout unit: bits per tile column
ENTRY_WIN = 48  # max bits one symbol group consumes (15+5+15+13)
MAX_CODE_LEN = 15  # full RFC 1951 range
SENT_EOB = 127  # delta sentinel: end-of-block symbol at this position
SENT_ERR = 255  # delta sentinel: decode error at this position

V2_LANE_BATCH = 256
V2_L_BUCKETS = (4, 16, 64, V2_LANE_BATCH)
# Cap on padded lanes x payload bytes per device dispatch.
WAVE_BYTES_CAP = 16 << 20

_ERR_END = reason_to_code(Reason.UNEXPECTED_END_OF_STREAM)
_ERR_RESERVED_LEN = reason_to_code(Reason.RESERVED_LENGTH_SYMBOL)
_ERR_RESERVED_DIST = reason_to_code(Reason.RESERVED_DISTANCE_SYMBOL)
_ERR_EMPTY_DIST = reason_to_code(Reason.LENGTH_ENCOUNTERED_WITH_EMPTY_DISTANCE_CODE)

TOKEN_MATCH_BIT = 1 << 26

# Minimal valid payload for padding lanes: a final fixed-Huffman block that
# is immediately end-of-block (bits: bfinal=1, btype=01, EOB 0000000).
_PAD_PAYLOAD = bytes([0x03, 0x00])

# Kernel layout (decode_pallas.py:56-104).
W_P = 512  # tile width in bits
E_WIN = 48  # entry offsets tracked per tile
# Level-1 token slots per tile, chosen per wave from the shortest token.
K1_CHOICES = (104, 136, 176)
# Payload byte buckets: multiples of 8192, so NT = P/64 is a multiple of 128.
P_BUCKETS_PALLAS = (8192, 16384, 24576, 32768, 40960, 49152, 65536, 73728, 139264, 270336)

# Per-lane meta row of the stage-A kernel (int32 columns; ladder bounds
# are uint32 bit-cast to int32).
MA_LLSAT = 0
MA_LLPACK = 16
MA_LLP2 = 32
MA_LLP3 = 48
MA_DSAT = 64
MA_DPACK = 80
MA_LLNLIVE = 96
MA_DNLIVE = 97
MA_DEMPTY = 98
MA_PBITS = 99
MA_EOB = 100
MA_INIT2 = 101
MA_INIT3 = 102
MA_MW = 104  # 11 match-descriptor plane words
MA_DPERM = 115  # 5 distance-symbol plane words
META_W = 128

# Summary rows of the stage-DC output (L, 8, NT).
ROW_COUNT = 0  # valid tokens in the tile
ROW_EOB_POS = 1  # in-tile bit offset of a reached EOB (or 0)
ROW_EOB_TOK = 2  # token value at the EOB position (-(1+len); 0 if none)
ROW_ERR_TOK = 3  # token value at a reached error position (-(100+code); 0)
ROW_SIZE_SUM = 4  # uncompressed bytes produced by the tile's tokens
ROW_EOB_HIT = 5  # 1 if the chain reached EOB inside this tile
ROW_ERR_HIT = 6  # 1 if the chain reached an error inside this tile
ROW_OVERFLOW = 7  # 1 if the tile had more than k1 tokens

ACC_BIAS = 1 << 12  # per-step bias keeping both 16-bit acc halves positive


def _bucket(value: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def canonical_tables(lengths: np.ndarray, max_len: int = MAX_CODE_LEN) -> dict:
    """(L, N) code lengths -> canonical range-decode tables per lane.

    first[l] = canonical first code of length l; base[l] = canonical index
    of the first length-l symbol; count[l] = #symbols of length l;
    syms[i] = symbol with canonical index i (sorted by (length, symbol),
    zero-length symbols pushed past the end).
    """
    L, N = lengths.shape
    counts = np.zeros((L, max_len + 1), np.int64)
    for l in range(1, max_len + 1):
        counts[:, l] = (lengths == l).sum(axis=1)
    first = np.zeros((L, max_len + 1), np.int64)
    base = np.zeros((L, max_len + 1), np.int64)
    code = np.zeros(L, np.int64)
    cum = np.zeros(L, np.int64)
    for l in range(1, max_len + 1):
        code = (code + counts[:, l - 1]) << 1
        first[:, l] = code
        base[:, l] = cum
        cum = cum + counts[:, l]
    key = np.where(lengths > 0, lengths, max_len + 1) * (N + 1) + np.arange(N)[None, :]
    order = np.argsort(key, axis=1, kind="stable")
    return {
        "first": first.astype(np.int32),
        "base": base.astype(np.int32),
        "count": counts.astype(np.int32),
        "syms": order.astype(np.int32),
    }


def ladder_tables(tables: dict) -> dict:
    """Canonical tables -> the bounds-ladder form the stage-A kernel uses.

    A code is decoded from a 32-bit *reversed* window v (stream bit p at
    bit 31) in one comparison ladder:

        len(v) = 1 + #{l in 1..14 : v >= bound[l]}
        idx(v) = (v >> (32 - len)) + base[len] - first[len]

    where bound[l] = (first[l] + count[l]) << (32 - l). Returns ``sat``
    (L, 16) uint32 (bounds saturated to 2**32-1), ``pack`` (L, 16) int32
    (per-step accumulator summand: biased offset delta in the low 20 bits,
    one step count at bit 20; 0 where the code space is complete) and
    ``nlive`` (L,) int32 (an idx >= nlive is an invalid code).
    """
    first = tables["first"].astype(np.int64)
    count = tables["count"].astype(np.int64)
    base = tables["base"].astype(np.int64)
    L, C = first.shape
    sat = np.zeros((L, 16), np.uint32)
    pack = np.zeros((L, 16), np.int32)
    off = base - first  # off[l] valid for l >= 1
    for l in range(1, 15):
        bound = (first[:, l] + count[:, l]) << (32 - l)
        full = bound >= (1 << 32)
        sat[:, l] = np.minimum(bound, (1 << 32) - 1).astype(np.uint32)
        doff = off[:, l + 1] - off[:, l]
        pack[:, l] = np.where(full, 0, (doff + (1 << 16)) + (1 << 20)).astype(np.int32)
    nlive = (base[:, 15] + count[:, 15]).astype(np.int32)
    return {"sat": sat, "pack": pack, "nlive": nlive}


def class_ladder_tables(lengths: np.ndarray, tables: dict) -> dict:
    """Litlen class/rank tables riding the bounds ladder.

    Within one code length, symbols sort ascending, so literals, the EOB,
    matches and reserved symbols occupy contiguous canonical-index runs.
    Two packed accumulators share the ladder's compare: ``acc2`` =
    lit_end (hi16) | res_start (lo16), ``acc3`` = lit_off (hi16) |
    mrank_off (lo16), each half biased by ACC_BIAS per ladder step.
    Match descriptors (run extra bits | run base - 3) are bit-sliced into
    11 plane words over the match rank; ``lit_planes`` holds the literal
    rank -> byte map as 8 bit planes over 8 words of 32 ranks.
    """
    L, N = lengths.shape
    first = tables["first"].astype(np.int64)
    count = tables["count"].astype(np.int64)
    base = tables["base"].astype(np.int64)
    nlive = (base[:, 15] + count[:, 15]).astype(np.int64)
    syms = tables["syms"]

    sym_ids = np.arange(N)[None, :]
    nlit = np.zeros((L, 16), np.int64)
    neob = np.zeros((L, 16), np.int64)
    nm = np.zeros((L, 16), np.int64)
    for l in range(1, 16):
        at = lengths == l
        nlit[:, l] = (at & (sym_ids < 256)).sum(axis=1)
        neob[:, l] = (at & (sym_ids == 256)).sum(axis=1)
        nm[:, l] = (at & (sym_ids >= 257) & (sym_ids <= 285)).sum(axis=1)
    cum_lit = np.cumsum(nlit, axis=1) - nlit  # literals with shorter length
    cum_m = np.cumsum(nm, axis=1) - nm

    lit_end = base + nlit
    res_start = base + nlit + neob + nm
    lit_off = cum_lit - base
    mrank_off = cum_m - (base + nlit + neob)

    l256 = lengths[:, 256].astype(np.int64) if N > 256 else np.zeros(L, np.int64)
    rows = np.arange(L)
    eob_cidx = np.where(
        l256 > 0, base[rows, l256] + nlit[rows, l256], np.int64(-(1 << 20))
    ).astype(np.int32)

    def pack_pair(hi: np.ndarray, lo: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-length (hi, lo) value pair -> (pack (L,16) int32, init (L,))."""
        pack = np.zeros((L, 16), np.int32)
        for l in range(1, 15):
            bound = (first[:, l] + count[:, l]) << (32 - l)
            full = bound >= (1 << 32)
            dhi = hi[:, l + 1] - hi[:, l] + ACC_BIAS
            dlo = lo[:, l + 1] - lo[:, l] + ACC_BIAS
            pack[:, l] = np.where(full, 0, (dhi << 16) + dlo).astype(np.int32)
        init = ((hi[:, 1] + ACC_BIAS) << 16) + (lo[:, 1] + ACC_BIAS)
        return pack, init.astype(np.int32)

    pack2, init2 = pack_pair(lit_end, res_start)
    pack3, init3 = pack_pair(lit_off, mrank_off)

    pos_valid = np.arange(N)[None, :] < nlive[:, None]
    is_m = (syms >= 257) & (syms <= 285) & pos_valid
    is_l = (syms < 256) & pos_valid
    mrank_arr = np.cumsum(is_m, axis=1) - 1
    lrank_arr = np.cumsum(is_l, axis=1) - 1

    mi = np.clip(syms - 257, 0, 28)
    mdesc = (LENGTH_EXTRA[mi] | ((LENGTH_BASE[mi] - 3) << 3)).astype(np.int64)
    mwords = np.zeros((L, 11), np.int64)
    for b in range(11):
        bit = ((mdesc >> b) & 1) & is_m
        mwords[:, b] = (bit.astype(np.int64) << np.clip(mrank_arr, 0, 31)).sum(axis=1)
    lit_map = np.zeros((L, 256), np.uint8)
    li, lj = np.nonzero(is_l)
    lit_map[li, lrank_arr[li, lj]] = syms[li, lj]
    grid = lit_map.reshape(L, 4, 64).transpose(0, 2, 1)  # (L, 64, 4)
    lit_map8 = np.concatenate(
        [(grid & 127).astype(np.int8), (grid >> 7).astype(np.int8)], axis=2
    )
    # Bit-plane form: column b*8+w holds bit b of ranks [32w, 32w+32).
    j32 = np.arange(32)[None, None, :]
    lm = lit_map.reshape(L, 8, 32).astype(np.int64)
    planes = np.zeros((L, 8, 8), np.int64)
    for b in range(8):
        planes[:, b, :] = (((lm >> b) & 1) << j32).sum(axis=2)
    lit_planes = planes.reshape(L, 64).astype(np.int32)
    return {
        "pack2": pack2,
        "init2": init2,
        "pack3": pack3,
        "init3": init3,
        "eob_cidx": eob_cidx,
        "mwords": mwords.astype(np.int32),
        "lit_map8": lit_map8,
        "lit_planes": lit_planes,
    }


def dist_perm_words(syms32: np.ndarray) -> np.ndarray:
    """(L, 32) sorted distance symbols -> (L, 5) int32 bit-plane words.

    Plane b, bit j = bit b of (symbol at canonical index j, clipped to
    31); the kernel derives the distance parameters in closed form.
    """
    s = np.clip(syms32, 0, 31).astype(np.int64)
    words = np.zeros((s.shape[0], 5), np.int64)
    j = np.arange(32)[None, :]
    for b in range(5):
        words[:, b] = (((s >> b) & 1) << j).sum(axis=1)
    return words.astype(np.int32)


def _byte_grid(shifted: np.ndarray) -> np.ndarray:
    """(L, P) payload rows -> (L, 64, NT+1) tile-major byte grid; the +1
    column is the zero tile past the end, so stage A's 9-byte lookahead
    never wraps."""
    L, P = shifted.shape
    assert P % 64 == 0
    NT = P // 64
    grid = np.zeros((L, 64, NT + 1), np.uint8)
    grid[:, :, :NT] = shifted.reshape(L, NT, 64).transpose(0, 2, 1)
    return grid


def _wave_arrays(rows: np.ndarray, row_bits: np.ndarray, hp) -> tuple[dict, np.ndarray]:
    """Byte-shift rows so the block body starts inside byte 0, build the
    tile-major byte grid and the canonical decode tables. Returns the
    wave input dict (NumPy) and the per-lane byte shift."""
    L, P = rows.shape
    shift2 = (hp.body_bitpos // 8).astype(np.int64)
    rem2 = (hp.body_bitpos % 8).astype(np.int32)
    shifted = np.zeros_like(rows)
    for i in range(L):
        s = int(shift2[i])
        shifted[i, : P - s] = rows[i, s:]
    body_bits = (row_bits - shift2 * 8).astype(np.int32)
    llt = canonical_tables(hp.litlen_lengths)
    dt = canonical_tables(hp.dist_lengths)
    lad = ladder_tables(llt)
    dlad = ladder_tables(dt)
    cls = class_ladder_tables(hp.litlen_lengths, llt)
    min_tok = int(lane_min_tok_bits(hp).min())
    w = {
        "_min_tok_bits": min_tok,
        "grid": _byte_grid(shifted),
        "payload_bits": body_bits,
        "ll_sat": lad["sat"],
        "ll_pack": lad["pack"],
        "ll_pack2": cls["pack2"],
        "ll_init2": cls["init2"],
        "ll_pack3": cls["pack3"],
        "ll_init3": cls["init3"],
        "ll_eob": cls["eob_cidx"],
        "ll_nlive": lad["nlive"],
        "ll_mwords": cls["mwords"],
        "lit_map8": cls["lit_map8"],
        "lit_planes": cls["lit_planes"],
        "d_sat": dlad["sat"],
        "d_pack": dlad["pack"],
        "d_nlive": dlad["nlive"],
        "d_perm": dist_perm_words(dt["syms"][:, :32]),
        "dist_empty": hp.dist_empty,
        "rem": rem2,
    }
    return w, shift2


def lane_min_tok_bits(hp) -> np.ndarray:
    """(L,) shortest bits one token can consume per lane: a literal/EOB
    costs its litlen code; a match its length code plus a distance code.
    Bounds the tokens a 512-bit tile can hold."""
    ll, dl = hp.litlen_lengths, hp.dist_lengths
    min_lit = np.where(ll[:, :257] > 0, ll[:, :257], 99).min(axis=1)
    min_len = np.where(ll[:, 257:] > 0, ll[:, 257:], 99).min(axis=1)
    min_dist = np.where(dl > 0, dl, 99).min(axis=1)
    return np.minimum(min_lit, min_len + min_dist)


def _lane_k1(min_tok: int) -> int:
    """The k1 bucket a lane with this min-token-bits bound lands in."""
    bound = W_TILE_P // max(int(min_tok), 1) + 1
    return next((k for k in K1_CHOICES if bound <= k), K1_CHOICES[-1])


def _k1_groups(payloads_or_rows, bitpos_list) -> list[int]:
    """Per-payload k1 bucket from a batched prefix header parse (headers
    fit well inside 1 KiB); on any parse trouble the lane gets the widest
    k1 and the full parse later raises the real error on the right lane."""
    n = len(payloads_or_rows)
    P = 1024
    rows = np.zeros((n, P), np.uint8)
    row_bits = np.zeros(n, np.int64)
    start_bits = np.zeros(n, np.int64)
    for i, (p, bp) in enumerate(zip(payloads_or_rows, bitpos_list)):
        sh = bp // 8
        m = max(0, min(len(p) - sh, P))
        rows[i, :m] = np.frombuffer(p, np.uint8, m, sh)
        row_bits[i] = m * 8
        start_bits[i] = bp % 8
    try:
        hp = dnp.parse_headers_batch(rows, row_bits, start_bits=start_bits)
        mt = lane_min_tok_bits(hp)
        return [_lane_k1(int(m)) for m in mt]
    except Exception:
        return [K1_CHOICES[-1]] * n


def _prep_wave(payloads: list[bytes], lanes: int | None, buckets: tuple[int, ...] | None = None):
    """Host prep of one lane wave (header parse + canonical tables +
    byte-shifted rows) for single-block-per-member streams."""
    L = _bucket(len(payloads), V2_L_BUCKETS) if lanes is None else lanes
    P = _bucket(max(len(p) for p in payloads), buckets or P_BUCKETS_PALLAS)
    rows = np.zeros((L, P), np.uint8)
    row_bits = np.zeros(L, np.int64)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
        row_bits[i] = len(p) * 8
    for i in range(len(payloads), L):
        rows[i, : len(_PAD_PAYLOAD)] = np.frombuffer(_PAD_PAYLOAD, np.uint8)
        row_bits[i] = len(_PAD_PAYLOAD) * 8
    hp = dnp.parse_headers_batch(rows, row_bits)
    w, _shift2 = _wave_arrays(rows, row_bits, hp)
    return w


def wave_to_tensors(w: dict, device: torch.device) -> dict:
    """Wave dict (NumPy, from :func:`_prep_wave` or :func:`_wave_arrays`)
    -> the same keys as tensors on ``device``. uint32 ladder bounds are
    bit-cast to int32 (the kernels compare them as unsigned); keys with a
    leading underscore are host scalars and pass through unchanged."""
    out = {}
    for k, v in w.items():
        if k.startswith("_"):
            out[k] = v
            continue
        a = np.ascontiguousarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a).to(device)
    return out
