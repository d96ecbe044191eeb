"""Member-parallel device encoder (counterpart of the member-parallel half
of ``tpu_deflate.codec.encode_jax``): data -> the TD-indexed multi-member
gzip profile stream, one 64 KiB member per lane.

All of it is PyTorch on the given device, apart from the kernels:

- **analyze, phase 1** (``analyze_phase1``): 4- and 3-byte (and, at
  quality >= 1, 6-byte) multiplicative hashes; per hash family one stable
  sort groups equal hashes, so the K nearest previous occurrences are
  static shifts of the sorted arrays, and the exact match length is
  compared on window words gathered into sorted order; arithmetic RLE
  lanes give exact runs at distances 1..4; a lazy deferral; then the
  parse's tile transfer maps (K8);
- **host entries** (``parse.host_entries``) between the phases;
- **analyze, phase 2** (``analyze_phase2``): the parse replay (K9), the
  symbols and extra bits of each token, and per-lane histograms;
- **planning** (``_plan_codes``): the histograms go to the host for the
  batched Huffman lengths, canonical codes and dynamic headers; the
  stored / fixed / dynamic bit costs are compared on the device
  (``route_strategies``) and fixed-routed lanes take the fixed tables
  (``_apply_route``);
- **emit** (``emit.emit_device``, K10) and **assembly**: the member
  CRC-32s on the device (``checksum_lanes.crc32_members``, the lane CRC
  kernel), the words pulled up to each batch's longest lane, stored
  framing for stored-routed lanes.

``compress_members`` runs the three stages as the reference's loop over
batches of ``ENC_LANE_BATCH`` lanes (``run_pipeline``): batch k+1's phase 1
is enqueued before batch k is planned and emitted, and batch k-1 is
assembled after. The continuous-history encode (``continuous.py``) runs the
same stages on halo rows, with the history masks of ``_match_find`` and
each lane's bfinal from ``_plan_codes``.

Every value is integer, and the output is byte-identical to
``encode_jax.compress_members_tpu`` at the same effort. uint32 arithmetic
(window words, hashes) runs in int64 masked to 32 bits; the sort-carried
window words are int32 bit patterns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..format.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS
from ..kernels.checksum_lanes import crc32_members
from ..kernels.huffman import huffman_lengths_batch
from ..native import _EMPTY_MEMBER
from . import parse as pp
from .decode_kernels import wrap_int32
from .emit import emit_device
from .encode_np import (
    MAX_CODE_BITS,
    MEMBER_DATA,
    build_headers,
    build_member,
    fix_histograms,
    pack_codes,
    stored_payload,
)

HASH_BITS = 16
ENC_LANE_BATCH = 64  # members per device batch
_M32 = 0xFFFFFFFF
_HASH_MUL = 2654435761
_H6_MUL = 0x9E3779B1
ROUTE_DYNAMIC, ROUTE_FIXED, ROUTE_STORED = 0, 1, 2

# Effort ladder of the matcher: quality selects the candidate count K and
# the exact-compare word caps W per hash family.
_QUALITY = {
    0: dict(K4=16, W4=9, K3=2, W3=2),  # efforts 0-2
    1: dict(K4=32, W4=16, K3=4, W3=2, K6=16, W6=16),  # efforts 3-4
    2: dict(K4=48, W4=16, K3=8, W3=2, K6=24, W6=16),  # effort 5
}

_I32 = torch.int32


def _run_to_symbol(run: torch.Tensor):
    """Closed-form run (3..258) -> (length symbol, extra bits, extra value)."""
    r3 = (run - 3).clamp(min=0)
    e = sum((r3 >= b).to(_I32) for b in (8, 16, 32, 64, 128))
    sym_hi = 257 + 4 * e + (r3 >> e)
    sym = torch.where(run <= 10, 254 + run, sym_hi)
    sym = torch.where(run >= 258, 285, sym)
    base = torch.where(sym <= 264, sym - 254, ((((sym - 257) & 3) + 4) << e) + 3)
    base = torch.where(sym == 285, 258, base)
    eb = torch.where((sym >= 265) & (sym <= 284), e, 0)
    return sym.to(_I32), eb.to(_I32), (run - base).to(_I32)


def _dist_to_symbol(dist: torch.Tensor):
    """Closed-form distance (1..32768) -> (symbol, extra bits, extra value)."""
    d1 = (dist - 1).clamp(min=0)
    e = sum((d1 >= (1 << (k + 1))).to(_I32) for k in range(1, 14))
    sym_hi = 2 * e + (d1 >> e)
    sym = torch.where(dist <= 4, d1, sym_hi)
    base = torch.where(sym <= 3, sym + 1, (((sym & 1) + 2) << e) + 1)
    eb = torch.where(sym >= 4, e, 0)
    return sym.to(_I32), eb.to(_I32), (dist - base).to(_I32)


def _u32_windows(data: torch.Tensor) -> torch.Tensor:
    """(L, S) uint8 -> (L, S) int64 little-endian 4-byte windows (zero
    padded), values in [0, 2**32)."""
    L, S = data.shape
    ext = torch.cat([data, data.new_zeros((L, 4))], dim=1).to(torch.int64)
    return ext[:, :S] | (ext[:, 1 : S + 1] << 8) | (ext[:, 2 : S + 2] << 16) | (ext[:, 3 : S + 3] << 24)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for int64 a in [0, 2**32), exact in int64."""
    return ((a & 0xFFFF) * m + (((a >> 16) * m & 0xFFFF) << 16)) & _M32


def _hash(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    h = (_mul32(x, _HASH_MUL) >> (32 - HASH_BITS)).to(_I32)
    return torch.where(valid, h, -1)


def _shr(a: torch.Tensor, k: int, fill: int = 0) -> torch.Tensor:
    """Shift each row right by k columns, filling with ``fill``."""
    return torch.cat([a.new_full((a.shape[0], k), fill), a[:, : a.shape[1] - k]], dim=1)


def _word_eqlen(x: torch.Tensor) -> torch.Tensor:
    """0..4 equal leading bytes of a xored little-endian word."""
    return (
        ((x & 0xFF) == 0).to(_I32)
        + ((x & 0xFFFF) == 0).to(_I32)
        + ((x & 0xFFFFFF) == 0).to(_I32)
        + (x == 0).to(_I32)
    )


def _bucket_best(h: torch.Tensor, w32i: torch.Tensor, K: int, nwords: int) -> torch.Tensor:
    """Best (match length, candidate position) per position among the K
    nearest earlier positions of the same hash, packed as
    ``cand + 1 | min(len, 4 nwords) << 32`` (int64, position order;
    :func:`_unpack_best` unpacks it). The reference packs an int32 with the
    length at bit 18, which a candidate past column 2**18 - 2 runs into
    (F11).

    A stable sort groups equal hashes with positions ascending, so the
    k-th previous occurrence is a shift by k of the sorted arrays; the
    exact prefix compare, up to 4 nwords bytes, runs on the window words
    gathered into sorted order. Ties keep the nearer candidate."""
    L, S = h.shape
    cap = 4 * nwords
    sorted_h, order = torch.sort(h, dim=1, stable=True)
    sw = []
    for j in range(nwords):
        src = order + 4 * j
        sw.append(torch.where(src < S, w32i.gather(1, src.clamp(max=S - 1)), 0))
    si = torch.arange(S, device=h.device).expand(L, S)
    changed = torch.ones_like(sorted_h, dtype=torch.bool)
    changed[:, 1:] = sorted_h[:, 1:] != sorted_h[:, :-1]
    rank = si - torch.cummax(torch.where(changed, si, -1), dim=1).values
    live = sorted_h != -1

    def lcpv(k: int) -> torch.Tensor:
        total = _word_eqlen(sw[0] ^ _shr(sw[0], k))
        full = total == 4
        for j in range(1, nwords):
            lj = _word_eqlen(sw[j] ^ _shr(sw[j], k))
            total = total + torch.where(full, lj, 0)
            full = full & (lj == 4)
        return total

    blen = torch.zeros((L, S), dtype=_I32, device=h.device)
    bcand = torch.full((L, S), -1, dtype=torch.int64, device=h.device)
    for k in range(1, K + 1):
        cand = _shr(order, k, -1)
        dist = order - cand
        ok = live & (rank >= k) & (dist >= 1) & (dist <= 32 * 1024)
        lc = torch.where(ok, lcpv(k), 0)
        better = lc > blen
        blen = torch.where(better, lc, blen)
        bcand = torch.where(better, cand, bcand)
    p1 = (bcand + 1) | (blen.clamp(max=cap).to(torch.int64) << 32)
    return torch.empty_like(p1).scatter_(1, order, p1)


def _unpack_best(q: torch.Tensor, idx: torch.Tensor):
    """:func:`_bucket_best`'s packing -> (match length, distance; 0 where
    there is no candidate), int32."""
    cand = (q & _M32) - 1
    return (q >> 32).to(_I32), torch.where(cand >= 0, idx - cand, 0).to(_I32)


def _suffix_runlen(eq: torch.Tensor) -> torch.Tensor:
    """Length of the run of True starting at each position, capped at 258
    (static-shift doubling rounds)."""
    L = eq.shape[0]
    r = eq.to(_I32)
    span = 1
    while span < 258:
        nxt = torch.cat([r[:, span:], r.new_zeros((L, span))], dim=1)
        r = torch.where(r == span, r + nxt, r)
        span *= 2
    return r.clamp(max=258)


def _match_find(data: torch.Tensor, lengths: torch.Tensor, lazy: bool, quality: int = 0,
                hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Match find: data (L, S) uint8, lengths (L,) int32 -> (use, dist,
    step, valid), the chosen run per position (0 = literal or deferred),
    its distance, the parse step and the mask of the positions that may be
    tokens.

    ``hist`` and ``hstart`` (L,) int32 are the continuous-history rows'
    (``continuous.py``): columns before ``hist`` are the 32 KiB history,
    match candidates but never tokens (their steps are 1, so the parse
    chain from column 0 lands on ``hist``), and columns before ``hstart``
    are row padding, neither. None: the whole row is the member."""
    q = _QUALITY[quality]
    L, S = data.shape
    devc = data.device
    idx = torch.arange(S, dtype=_I32, device=devc).expand(L, S)
    valid = idx < lengths[:, None]
    if hstart is not None:
        valid &= idx >= hstart[:, None]
    w32 = _u32_windows(data)
    w32i = wrap_int32(w32).to(_I32)

    q1 = _bucket_best(_hash(w32, valid), w32i, q["K4"], q["W4"])
    # 3-byte hash: run-3 matches and windows broken in their fourth byte.
    q3 = _bucket_best(_hash(w32 & 0xFFFFFF, valid), w32i, q["K3"], q["W3"])
    limit = (lengths[:, None] - idx).clamp(max=258)
    l1, d1 = _unpack_best(q1, idx)
    l3, d3 = _unpack_best(q3, idx)
    take3 = (l3 > l1) | ((l3 == l1) & (l3 > 0) & (d3 < d1))
    run = torch.minimum(torch.where(take3, l3, l1), limit)
    dist = torch.where(take3, d3, d1)

    if "K6" in q:
        # 6-byte hash: bytes 4..5 mixed into the 4-byte window's hash.
        ext6 = torch.cat([data, data.new_zeros((L, 6))], dim=1).to(torch.int64)
        b45 = ext6[:, 4 : S + 4] | (ext6[:, 5 : S + 5] << 8)
        q6 = _bucket_best(_hash(w32 ^ _mul32(b45, _H6_MUL), valid), w32i, q["K6"], q["W6"])
        l6, d6 = _unpack_best(q6, idx)
        l6 = torch.minimum(l6, limit)
        take6 = (l6 > run) | ((l6 == run) & (l6 > 0) & (d6 < dist))
        run = torch.where(take6, l6, run)
        dist = torch.where(take6, d6, dist)

    # Arithmetic RLE lanes: exact match lengths at distances 1..4; ascending
    # d with strict > keeps the smallest distance on ties. A position whose
    # byte d back is row padding has no match there (the reference compares
    # with the padding's zeros, F1).
    d32 = data.to(_I32)
    rle_run = torch.zeros((L, S), dtype=_I32, device=devc)
    rle_dist = torch.zeros((L, S), dtype=_I32, device=devc)
    for d in range(1, 5):
        eq = d32 == _shr(d32, d, -1)
        if hstart is not None:
            eq &= idx >= hstart[:, None] + d
        rl = torch.minimum(_suffix_runlen(eq), limit)
        better = rl > rle_run
        rle_run = torch.where(better, rl, rle_run)
        rle_dist = torch.where(better, d, rle_dist)
    take_rle = (rle_run >= 3) & ((rle_run > run) | ((rle_run == run) & (rle_dist < dist)))
    run = torch.where(take_rle, rle_run, run).clamp(max=pp.PARSE_MAX_STEP)
    dist = torch.where(take_rle, rle_dist, dist)

    # Worthwhile-match heuristics (zlib-style): short far matches lose.
    good = (run >= 4) | ((run == 3) & (dist <= 4096))
    use = torch.where(good, run, 0)
    dist = torch.where(good, dist, 0)
    if lazy:  # defer a match when the next position starts a longer one
        nxt_run = torch.cat([use[:, 1:], use.new_zeros((L, 1))], dim=1)
        use = torch.where((use > 0) & (nxt_run > use), 0, use)
    if hist is not None:
        in_payload = idx >= hist[:, None]
        use = torch.where(in_payload, use, 0)
        dist = torch.where(in_payload, dist, 0)
        valid &= in_payload
    step = torch.where(use > 0, use, 1)
    return use, dist, step, valid


def _finish_analysis(data, use, dist, is_token):
    """Token selection -> symbols, extra bits and per-lane histograms."""
    L = data.shape[0]
    is_match = is_token & (use > 0)
    rsym, reb, rev_ = _run_to_symbol(torch.where(is_match, use, 3).clamp(3, 258))
    dsym, deb, dev_ = _dist_to_symbol(torch.where(is_match, dist, 1).clamp(1, 32768))
    litlen_sym = torch.where(is_match, rsym, data.to(_I32))
    dist_sym = torch.where(is_match, dsym, 0)
    lanes = torch.arange(L, device=data.device)[:, None]

    def hist(keys: torch.Tensor, nbins: int) -> torch.Tensor:
        """Per-lane counts of keys in [0, nbins); key nbins is the trash bin."""
        flat = (keys.to(torch.int64) + lanes * (nbins + 1)).view(-1)
        counts = torch.bincount(flat, minlength=L * (nbins + 1)).view(L, nbins + 1)
        return counts[:, :nbins].to(_I32)

    return {
        "is_token": is_token,
        "is_match": is_match,
        "litlen_sym": litlen_sym,
        "len_eb": torch.where(is_match, reb, 0),
        "len_ev": torch.where(is_match, rev_, 0),
        "dist_sym": dist_sym,
        "dist_eb": torch.where(is_match, deb, 0),
        "dist_ev": torch.where(is_match, dev_, 0),
        "litlen_hist": hist(torch.where(is_token, litlen_sym, 288), 288),
        "dist_hist": hist(torch.where(is_match, dist_sym, 30), 30),
    }


def analyze_phase1(data: torch.Tensor, lengths: torch.Tensor, lazy: bool = True, quality: int = 0,
                   hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Match find + the parse's tile transfer maps (K8)."""
    use, dist, step, valid = _match_find(data, lengths, lazy, quality, hist, hstart)
    tiles = pp.step_tiles(step)
    return {"use": use, "dist": dist, "tiles": tiles, "valid": valid,
            "transfers": pp.parse_transfers(tiles)}


def analyze_phase2(data, use, dist, tiles, valid, entries):
    """Replay the true chain (K9), then symbols and histograms."""
    return _finish_analysis(data, use, dist, pp.parse_replay(tiles, entries) & valid)


def analyze(data: torch.Tensor, lengths: torch.Tensor, lazy: bool = True, quality: int = 0,
            hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Both phases with the host walk between them: the analysis of one
    batch, keyed as ``encode_jax.analyze_device``'s (with the same
    ``hist``/``hstart``)."""
    p1 = analyze_phase1(data, lengths, lazy, quality, hist, hstart)
    entries = pp.host_entries(p1["transfers"].cpu().numpy())
    ent = torch.from_numpy(entries).to(data.device)
    return analyze_phase2(data, p1["use"], p1["dist"], p1["tiles"], p1["valid"], ent)


# ---------------------------------------------------------------------------
# Routing and planning
# ---------------------------------------------------------------------------


def route_strategies(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths):
    """Per-lane argmin over stored / fixed / dynamic bit costs, from the
    token histograms (no EOB, no bumps), the planned dynamic code lengths
    and header bits, and the member lengths; int32 throughout. Returns
    (choice, dyn_bits, fixed_bits, stored_bits), each (L,)."""
    devc = ll_hist.device
    sym = torch.arange(288, dtype=_I32, device=devc)[None, :]
    len_extra = torch.where((sym >= 265) & (sym <= 284), (sym - 261) >> 2, 0)
    dsym = torch.arange(30, dtype=_I32, device=devc)[None, :]
    dist_extra = ((dsym >> 1) - 1).clamp(min=0)

    def dot(a, b):
        return (a * b).sum(dim=1, dtype=_I32)

    extras = dot(ll_hist, len_extra) + dot(d_hist, dist_extra)
    fix_ll = torch.where(sym < 144, 8, torch.where(sym < 256, 9, torch.where(sym < 280, 7, 8)))
    dyn = hdr_bits + dot(ll_hist, ll_len) + dot(d_hist, d_len) + extras + ll_len[:, 256]
    fixed = 3 + dot(ll_hist, fix_ll) + dot(d_hist, torch.full_like(d_hist, 5)) + extras + 7
    stored = 8 * (lengths + 5 * ((lengths + 65534) // 65535) + 1)
    choice = torch.where(
        stored < torch.minimum(dyn, fixed),
        ROUTE_STORED,
        torch.where(fixed < dyn, ROUTE_FIXED, ROUTE_DYNAMIC),
    ).to(_I32)
    return choice, dyn, fixed, stored


def _apply_route(choice, ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits, fix_ll,
                 fix_d, final=None):
    """Swap the fixed-Huffman codes, header (bfinal, btype 01) and EOB into
    lanes routed FIXED. ``final`` (L,) 0/1 is each lane's bfinal (None:
    every lane is final)."""
    f = (choice == ROUTE_FIXED)[:, None]
    fin = 1 if final is None else final.to(header_vals.dtype)
    ll = torch.where(f, fix_ll, ll_codes)
    dd = torch.where(f, fix_d, d_codes)
    hv = torch.where(f, 0, header_vals)
    hv[:, 0] = torch.where(f[:, 0], fin | 2, header_vals[:, 0])
    hb = torch.where(f, 0, header_bits)
    hb[:, 0] = torch.where(f[:, 0], 3, header_bits[:, 0])
    ev = torch.where(f[:, 0], 0, eob_val)
    eb = torch.where(f[:, 0], 7, eob_bits)
    return ll, dd, hv, hb, ev, eb


@functools.lru_cache(maxsize=1)
def _fixed_code_tables() -> tuple[np.ndarray, np.ndarray]:
    fl = pack_codes(FIXED_LITLEN_LENGTHS[None, :].astype(np.int64), MAX_CODE_BITS)
    fd = pack_codes(FIXED_DIST_LENGTHS[None, :30].astype(np.int64), MAX_CODE_BITS)
    return fl, fd


def _plan_codes(a: dict, lengths: np.ndarray, final: np.ndarray | None = None):
    """Pull the histograms, plan lengths, codes and headers on the host,
    route each lane on the device. ``lengths`` are the bytes each lane
    codes (its stored cost), ``final`` (L,) 0/1 each lane's bfinal (None:
    all final). Returns the emit's code and header tensors (on the
    histograms' device) and the route choice."""
    devc = a["litlen_hist"].device

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(devc)

    litlen_hist, dist_hist = fix_histograms(a["litlen_hist"].cpu().numpy(),
                                            a["dist_hist"].cpu().numpy())
    ll_lengths = huffman_lengths_batch(litlen_hist, MAX_CODE_BITS)
    d_lengths = huffman_lengths_batch(dist_hist, MAX_CODE_BITS)
    ll_codes = pack_codes(ll_lengths, MAX_CODE_BITS)
    d_codes = pack_codes(d_lengths, MAX_CODE_BITS)
    header_vals, header_bits = build_headers(ll_lengths, d_lengths, final)
    choice, _dyn, _fx, _st = route_strategies(
        a["litlen_hist"], a["dist_hist"], put(ll_lengths.astype(np.int32)),
        put(d_lengths.astype(np.int32)), put(header_bits.sum(axis=1).astype(np.int32)),
        put(np.asarray(lengths, np.int32)),
    )
    fl, fd = _fixed_code_tables()
    routed = _apply_route(
        choice, put(ll_codes), put(d_codes), put(header_vals.astype(np.int64)), put(header_bits),
        put((ll_codes[:, 256] & 0xFFFF).astype(np.int64)), put(ll_codes[:, 256] >> 16),
        put(fl), put(fd), None if final is None else put(np.asarray(final, np.int64)),
    )
    return (*routed, choice)


# ---------------------------------------------------------------------------
# The three stages
# ---------------------------------------------------------------------------


def dispatch_phase1(dd: torch.Tensor, lengths: torch.Tensor, lazy: bool, quality: int,
                    hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Stage 1 of an uploaded batch: enqueue phase 1 and the copy of its
    transfer maps to the host -> (phase 1's dict, the host maps, the event
    that marks them copied or None on the CPU)."""
    p1 = analyze_phase1(dd, lengths, lazy, quality, hist, hstart)
    if dd.device.type != "cuda":
        return p1, p1["transfers"], None
    host = torch.empty(p1["transfers"].shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(p1["transfers"], non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return p1, host, done


def _pad_batch(chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One lane batch on the host: (rows (L, MEMBER_DATA) uint8, a lane per
    member and the last one zero padded, the bytes each lane codes)."""
    n = chunk.size
    L = -(-n // MEMBER_DATA)
    lengths = np.full(L, MEMBER_DATA, dtype=np.int32)
    lengths[-1] = n - (L - 1) * MEMBER_DATA
    padded = np.zeros((L, MEMBER_DATA), dtype=np.uint8)
    padded.reshape(-1)[:n] = chunk
    return padded, lengths


def _dispatch_staged(dd: torch.Tensor, padded: np.ndarray, lengths: np.ndarray, lazy: bool, quality: int):
    """Stage 1 of a batch already on the device: ``dd`` holds the rows
    ``padded`` of :func:`_pad_batch` (the kernel-only bench stages them
    before its clock starts), then :func:`dispatch_phase1`."""
    p1, host, done = dispatch_phase1(dd, torch.from_numpy(lengths).to(dd.device), lazy, quality)
    return dd, p1, host, done, padded, lengths


def _dispatch_analyze(chunk: np.ndarray, lazy: bool, quality: int, device: torch.device):
    """Stage 1: one lane batch (:func:`_pad_batch`), uploaded, then
    :func:`_dispatch_staged`."""
    padded, lengths = _pad_batch(chunk)
    return _dispatch_staged(torch.from_numpy(padded).to(device), padded, lengths, lazy, quality)


def emit_inputs(pend, final: np.ndarray | None = None):
    """The host walk, phase 2 and planning of one dispatched batch ->
    (the arguments of ``emit_device``, the parse's step tiles, the entries,
    the route choice). ``pend`` is (rows on the device, :func:`dispatch_phase1`'s
    three results, the caller's, the bytes each lane codes); ``final`` as
    :func:`_plan_codes` takes it."""
    dd, p1, host, done, _caller, lengths = pend
    if done is not None:
        done.synchronize()
    entries = torch.from_numpy(pp.host_entries(host.numpy())).to(dd.device)
    a = analyze_phase2(dd, p1["use"], p1["dist"], p1["tiles"], p1["valid"], entries)
    ll_c, d_c, hv, hb, ev, eb, choice = _plan_codes(a, lengths, final)
    flags = a["is_token"].to(_I32) | (a["is_match"].to(_I32) << 1)
    args = (a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"], a["dist_eb"],
            a["dist_ev"], ll_c, d_c, hv, hb, ev, eb)
    return args, p1["tiles"], entries, choice


def _plan_and_emit(pend):
    """Stage 2: :func:`emit_inputs`, then the emit."""
    args, _tiles, _entries, choice = emit_inputs(pend)
    words, total_bits = emit_device(*args)
    dd, _p1, _host, _done, padded, lengths = pend
    return words, total_bits, choice, dd, padded, lengths


def _assemble_members(em) -> bytes:
    """Stage 3: member CRCs on the device, the words pulled up to the
    longest lane, members framed on the host."""
    words, total_bits, choice, dd, padded, lengths = em
    crcs = crc32_members(dd, lengths)
    total_bits = total_bits.cpu().numpy()
    mw = min(words.shape[1], -(-int(total_bits.max()) // 32 // 512) * 512 or 512)
    payload_bytes = words[:, :mw].contiguous().cpu().numpy().view(np.uint8)
    choice = choice.cpu().numpy()
    out = bytearray()
    for l in range(len(lengths)):
        ln = int(lengths[l])
        nbytes = (int(total_bits[l]) + 7) // 8
        stored_cost = ln + 5 * (-(-ln // 65535)) + 1
        # The device's route, with the emitted size as a backstop: a lane
        # never grows past the stored bound (this also frames lanes whose
        # bits overflowed the word grid).
        if choice[l] == ROUTE_STORED or nbytes >= stored_cost:
            payload = stored_payload(padded[l, :ln].tobytes())
        else:
            payload = payload_bytes[l, :nbytes].tobytes()
        out += build_member(payload, ln, int(crcs[l]))
    return bytes(out)


def compress_members(data: bytes, *, device: torch.device, effort: int = 2) -> bytes:
    """Encode ``data`` as the TD-indexed multi-member profile stream on
    ``device`` (kernels on a CUDA device, their plain versions on the CPU).

    ``effort`` maps to the matcher as in the reference: <= 1 greedy parse,
    2 lazy, 3-4 lazy with the widened candidate set and the 6-byte hash,
    >= 5 the deepest candidate set."""
    n = len(data)
    if n == 0:
        return _EMPTY_MEMBER
    lazy = effort >= 2
    quality = 2 if effort >= 5 else (1 if effort >= 3 else 0)
    buf = np.frombuffer(data, dtype=np.uint8)
    step = ENC_LANE_BATCH * MEMBER_DATA
    chunks = [buf[base : base + step] for base in range(0, n, step)]
    out = bytearray()
    run_pipeline(chunks, lambda c: _dispatch_analyze(c, lazy, quality, device), _plan_and_emit,
                 lambda em: out.extend(_assemble_members(em)))
    return bytes(out)


def run_pipeline(batches: list, dispatch, emit, assemble) -> None:
    """The three stages over ``batches`` in order: batch k+1's
    ``dispatch`` (stage 1) is enqueued before batch k's ``emit`` (stage 2),
    and batch k-1's ``assemble`` (stage 3) runs after it."""
    pend = dispatch(batches[0])
    ready = None
    for i in range(len(batches)):
        cur = pend
        pend = dispatch(batches[i + 1]) if i + 1 < len(batches) else None
        em = emit(cur)
        if ready is not None:
            assemble(ready)
        ready = em
    assemble(ready)
