"""Member-parallel device encoder (counterpart of the member-parallel half
of ``tpu_deflate.codec.encode_jax``): data -> the TD-indexed multi-member
gzip profile stream, one 64 KiB member per lane.

All of it is PyTorch on the given device, apart from the kernels:

- **analyze, phase 1** (``analyze_phase1``): the match finder
  (``_match_find``), then the parse's tile transfer maps (K8). The hash
  families (4- and 3-byte, and at quality >= 1 6-byte multiplicative
  hashes) link each position to the nearest earlier position of the same
  hash (zlib's head/prev chains), so the K nearest previous occurrences of
  a position's hash are its first K hops along the links, and their exact
  match lengths are compared; then arithmetic
  RLE lanes give exact runs at distances 1..4, and a filter, a lazy
  deferral and the history masks choose each position's run. On CUDA
  tensors the keys, the links, the compare and the selection are the
  kernels of ``csrc/match.cu`` (``match_keys``, ``match_chain``,
  ``match_bucket``, ``match_select``); on CPU tensors their plain
  versions;
- **host entries** (``parse.host_entries``) between the phases;
- **analyze, phase 2** (``analyze_phase2``): the parse replay (K9), then
  the symbols and extra bits of each token, the per-lane histograms and
  K10's token flags (``_finish_analysis``: one kernel of ``csrc/finish.cu``
  on CUDA tensors, its plain version on CPU tensors);
- **planning** (``_plan_codes``): the histograms go to the host for the
  batched Huffman lengths, canonical codes and dynamic headers, which go
  back in one upload;
- **emit** (``emit.emit_routed``: one kernel of ``csrc/emit.cu`` on CUDA
  tensors) and **assembly**: the launch compares each lane's stored /
  fixed / dynamic bit costs, takes the fixed tables for fixed-routed lanes
  and packs header, body (K10) and EOB; then the member CRC-32s on the
  device (``checksum_lanes.crc32_members``, the lane CRC kernel), the
  words pulled up to each batch's longest lane, stored framing for
  stored-routed lanes.

``compress_members`` runs the three stages as the reference's loop over
batches of ``ENC_LANE_BATCH`` lanes (``run_pipeline``): batch k+1's phase 1
is enqueued before batch k is planned and emitted, and batch k-1 is
assembled after. The continuous-history encode (``continuous.py``) runs the
same stages on halo rows, with the history masks of ``_match_find`` and
each lane's bfinal from ``_plan_codes``.

Every value is integer, and the output is byte-identical to
``encode_jax.compress_members_tpu`` at the same effort. In the plain
versions uint32 arithmetic (window words, hashes) runs in int64 masked to
32 bits, and the window words gathered at the candidates are int32 bit
patterns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .._build import ENCODE_LAUNCHES
from ..format.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS
from ..kernels.checksum_lanes import crc32_members
from ..kernels.huffman import huffman_lengths_batch
from ..native import _EMPTY_MEMBER
from ..spans import span
from . import parse as pp
from .decode_kernels import wrap_int32
from . import emit as em
from .emit import (  # noqa: F401  (the routing's spec, re-exported with the planner's names)
    ROUTE_DYNAMIC,
    ROUTE_FIXED,
    ROUTE_STORED,
    route,
    route_plain,
)
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


FAMILY_4, FAMILY_3, FAMILY_6 = 0, 1, 2  # the hash families, as td_match_keys takes them
# Each family's (candidate count, compare words) keys in _QUALITY.
_FAMILIES = ((FAMILY_4, "K4", "W4"), (FAMILY_3, "K3", "W3"), (FAMILY_6, "K6", "W6"))
_MAX_WORDS = 16  # the widest compare the bucket kernel stages a zero tail for
MAX_DIST = 32768  # the farthest candidate


def _positions(data: torch.Tensor, lengths: torch.Tensor, hstart: torch.Tensor | None):
    """(column index (L, S) int32, the mask of positions that may be
    tokens: below the lane's length and, with ``hstart``, not row padding)."""
    L, S = data.shape
    idx = torch.arange(S, dtype=_I32, device=data.device).expand(L, S)
    valid = idx < lengths[:, None]
    if hstart is not None:
        valid &= idx >= hstart[:, None]
    return idx, valid


def _match_keys_plain(data: torch.Tensor, lengths: torch.Tensor, families: tuple,
                      hstart: torch.Tensor | None = None) -> torch.Tensor:
    """Plain ``td_match_keys``: (F, L, S) int32, for each of the F hash
    families its 16-bit hash of the zero-extended row at each position
    (4-byte window; 3-byte; 6-byte: bytes 4..5 mixed into the 4-byte
    window's hash), or -1 where the position is not valid."""
    L, S = data.shape
    _idx, valid = _positions(data, lengths, hstart)
    w32 = _u32_windows(data)
    out = []
    for family in families:
        x = w32
        if family == FAMILY_3:
            x = w32 & 0xFFFFFF
        elif family == FAMILY_6:
            ext6 = torch.cat([data, data.new_zeros((L, 6))], dim=1).to(torch.int64)
            x = w32 ^ _mul32(ext6[:, 4 : S + 4] | (ext6[:, 5 : S + 5] << 8), _H6_MUL)
        out.append(_hash(x, valid))
    return torch.stack(out)


def _match_chain_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain ``td_match_chain``: the hashes (F, L, S) int32 of
    :func:`_match_keys_plain` -> (F, L, S) uint16, at each position the
    distance back to the nearest earlier position of the same hash, or 0
    where there is none within ``MAX_DIST`` (and where the key is -1).

    A stable sort along each row groups each hash with its positions
    ascending, so a position's link is the distance to the entry before it
    in its group."""
    F, L, S = keys.shape
    sorted_h, order = torch.sort(keys.reshape(F * L, S), dim=1, stable=True)
    same = (sorted_h[:, 1:] == sorted_h[:, :-1]) & (sorted_h[:, 1:] != -1)
    d = order[:, 1:] - order[:, :-1]
    link = torch.where(same & (d <= MAX_DIST), d, 0)
    prev = torch.zeros((F * L, S), dtype=torch.int64, device=keys.device)
    prev.scatter_(1, order[:, 1:], link)
    return prev.to(torch.uint16).view(F, L, S)


def _bucket_best_plain(prev: torch.Tensor, data: torch.Tensor, ks: tuple, nwords: tuple) -> torch.Tensor:
    """Plain ``td_match_bucket``: each family's links (F, L, S) uint16 (of
    :func:`_match_chain_plain`), the rows (L, S) uint8 and each family's
    candidate count and compare words -> (F, L, S) int64, for each family
    and position the best (match length, candidate position) among its
    first K hops along the links that lie 1..``MAX_DIST`` back, packed as
    ``cand + 1 | min(len, 4 nwords) << 32`` (:func:`_unpack_best` unpacks
    it). The reference packs an int32 with the length at bit 18, which a
    candidate past column 2**18 - 2 runs into (F11).

    Hop k gathers the k-th candidate of every position; the exact prefix
    compare, up to 4 nwords bytes, runs on the window words of both
    positions (zeros past the row). Ties keep the nearer candidate."""
    F, L, S = prev.shape
    dev = data.device
    idx = torch.arange(S, device=dev).expand(L, S)
    width = 4 * max(nwords)
    w32i = torch.cat([wrap_int32(_u32_windows(data)).to(_I32), torch.zeros((L, width), dtype=_I32, device=dev)],
                     dim=1)
    own = [w32i[:, 4 * j : 4 * j + S] for j in range(max(nwords))]
    out = []
    for f in range(F):
        link = prev[f].to(torch.int64)
        cand = idx.clone()
        alive = torch.ones((L, S), dtype=torch.bool, device=dev)
        blen = torch.zeros((L, S), dtype=_I32, device=dev)
        bcand = torch.full((L, S), -1, dtype=torch.int64, device=dev)
        for _k in range(ks[f]):
            d = link.gather(1, cand)
            alive = alive & (d > 0)
            cand = torch.where(alive, cand - d, cand)
            alive = alive & (idx - cand <= MAX_DIST)
            total = _word_eqlen(own[0] ^ w32i.gather(1, cand))
            full = total == 4
            for j in range(1, nwords[f]):
                lj = _word_eqlen(own[j] ^ w32i.gather(1, cand + 4 * j))
                total = total + torch.where(full, lj, 0)
                full = full & (lj == 4)
            better = alive & (total > blen)
            blen = torch.where(better, total, blen)
            bcand = torch.where(better, cand, bcand)
        out.append((bcand + 1) | (blen.clamp(max=4 * nwords[f]).to(torch.int64) << 32))
    return torch.stack(out)


def _unpack_best(q: torch.Tensor, idx: torch.Tensor):
    """:func:`_bucket_best_plain`'s packing -> (match length, distance; 0
    where there is no candidate), int32."""
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


def _match_select_plain(data: torch.Tensor, lengths: torch.Tensor, lazy: bool, q4: torch.Tensor,
                        q3: torch.Tensor, q6: torch.Tensor | None = None, hist: torch.Tensor | None = None,
                        hstart: torch.Tensor | None = None):
    """Plain ``td_match_select``: the rows and the packed best matches of
    the 4-, 3- and (or None) 6-byte families -> (use, dist, step, valid) of
    :func:`_match_find`."""
    L, S = data.shape
    devc = data.device
    idx, valid = _positions(data, lengths, hstart)
    limit = (lengths[:, None] - idx).clamp(max=258)
    l1, d1 = _unpack_best(q4, idx)
    l3, d3 = _unpack_best(q3, idx)
    # 3-byte hash: run-3 matches and windows broken in their fourth byte.
    take3 = (l3 > l1) | ((l3 == l1) & (l3 > 0) & (d3 < d1))
    run = torch.minimum(torch.where(take3, l3, l1), limit)
    dist = torch.where(take3, d3, d1)

    if q6 is not None:
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


def _check_rows(data: torch.Tensor, lengths: torch.Tensor, *masks: torch.Tensor | None) -> list:
    """Check the match kernels' common inputs; returns the masks given."""
    _build.check_tensor("data", data, torch.uint8, 2)
    _build.check_tensor("lengths", lengths, _I32, 1)
    L = data.shape[0]
    _build.require(lengths.shape[0] == L, f"lengths: shape {tuple(lengths.shape)}")
    given = [m for m in masks if m is not None]
    for m in given:
        _build.check_tensor("hist/hstart", m, _I32, 1)
        _build.require(m.shape[0] == L, f"hist/hstart: shape {tuple(m.shape)}")
    return given


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def match_keys(data: torch.Tensor, lengths: torch.Tensor, families: tuple,
               hstart: torch.Tensor | None = None) -> torch.Tensor:
    """``td_match_keys``: data (L, S) uint8, lengths (L,) int32, hash
    families (each ``FAMILY_*``), hstart (L,) int32 or None -> (F, L, S)
    int32 hashes (-1 where the position is not valid)."""
    given = _check_rows(data, lengths, hstart)
    _build.require(1 <= len(families) <= 3 and all(f in (FAMILY_4, FAMILY_3, FAMILY_6) for f in families),
                   f"families {families}")
    if not _build.on_card(data, lengths, *given):
        return _match_keys_plain(data, lengths, families, hstart)
    L, S = data.shape
    dev = data.device
    keys = torch.empty((len(families), L, S), dtype=_I32, device=dev)
    codes = sum(f << (2 * i) for i, f in enumerate(families))
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_match_keys(data.data_ptr(), lengths.data_ptr(), _ptr(hstart), keys.data_ptr(), L, S,
                                len(families), codes, _build.stream(dev))
    _build.check(err, "td_match_keys")
    ENCODE_LAUNCHES["match_keys"] += 1
    return keys


def match_chain(keys: torch.Tensor) -> torch.Tensor:
    """``td_match_chain``: the hash families' keys (F, L, S) int32 ->
    (F, L, S) uint16 links, the distance back to the nearest earlier
    position of the same hash (0: none within ``MAX_DIST``)."""
    _build.check_tensor("keys", keys, _I32, 3)
    if not _build.on_card(keys):
        return _match_chain_plain(keys)
    F, L, S = keys.shape
    dev = keys.device
    prev = torch.empty((F, L, S), dtype=torch.uint16, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_match_chain(keys.data_ptr(), prev.data_ptr(), L, S, F, _build.stream(dev))
    _build.check(err, "td_match_chain")
    ENCODE_LAUNCHES["match_chain"] += 1
    return prev


def match_bucket(prev: torch.Tensor, data: torch.Tensor, ks: tuple, nwords: tuple) -> torch.Tensor:
    """``td_match_bucket``: every family's links (F, L, S) uint16, data
    (L, S) uint8, each family's candidate count K and compare words ->
    (F, L, S) int64 packed best matches in position order."""
    _build.check_tensor("prev", prev, torch.uint16, 3)
    _build.check_tensor("data", data, torch.uint8, 2)
    F = prev.shape[0]
    _build.require(prev.shape[1:] == data.shape, f"prev {tuple(prev.shape)}, data {tuple(data.shape)}")
    _build.require(len(ks) == len(nwords) == F <= 3 and all(1 <= k <= 255 for k in ks)
                   and all(1 <= w <= _MAX_WORDS for w in nwords), f"K {ks}, nwords {nwords}")
    if not _build.on_card(prev, data):
        return _bucket_best_plain(prev, data, ks, nwords)
    L, S = data.shape
    dev = data.device
    out = torch.empty((F, L, S), dtype=torch.int64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_match_bucket(prev.data_ptr(), data.data_ptr(), out.data_ptr(), L, S, F, _pack_bytes(ks),
                                  _pack_bytes(nwords), _build.stream(dev))
    _build.check(err, "td_match_bucket")
    ENCODE_LAUNCHES["match_bucket"] += 1
    return out


def _pack_bytes(values: tuple) -> int:
    """Family f's value in bits 8f..8f+7, as td_match_bucket takes K and nwords."""
    return sum(v << (8 * f) for f, v in enumerate(values))


def match_select(data: torch.Tensor, lengths: torch.Tensor, lazy: bool, q4: torch.Tensor, q3: torch.Tensor,
                 q6: torch.Tensor | None = None, hist: torch.Tensor | None = None,
                 hstart: torch.Tensor | None = None):
    """``td_match_select``: the rows, the packed best matches of the 4-, 3-
    and (or None) 6-byte families, the history masks -> (use, dist, step,
    valid)."""
    given = _check_rows(data, lengths, hist, hstart)
    packs = [q for q in (q4, q3, q6) if q is not None]
    for q in packs:
        _build.check_tensor("packed matches", q, torch.int64, 2)
        _build.require(q.shape == data.shape, f"packed matches: shape {tuple(q.shape)}")
    if not _build.on_card(data, lengths, *packs, *given):
        return _match_select_plain(data, lengths, lazy, q4, q3, q6, hist, hstart)
    L, S = data.shape
    dev = data.device
    use, dist, step = (torch.empty((L, S), dtype=_I32, device=dev) for _ in range(3))
    valid = torch.empty((L, S), dtype=torch.bool, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_match_select(data.data_ptr(), lengths.data_ptr(), q4.data_ptr(), q3.data_ptr(), _ptr(q6),
                                  _ptr(hist), _ptr(hstart), use.data_ptr(), dist.data_ptr(), step.data_ptr(),
                                  valid.data_ptr(), L, S, int(lazy), _build.stream(dev))
    _build.check(err, "td_match_select")
    ENCODE_LAUNCHES["match_select"] += 1
    return use, dist, step, valid


def _match_find(data: torch.Tensor, lengths: torch.Tensor, lazy: bool, quality: int = 0,
                hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Match find: data (L, S) uint8, lengths (L,) int32 -> (use, dist,
    step, valid), the chosen run per position (0 = literal or deferred),
    its distance, the parse step and the mask of the positions that may be
    tokens. The hash families' keys, their same-hash links, every family's
    candidate compare, then the selection; on CUDA tensors each step is a
    kernel of ``csrc/match.cu``.

    ``hist`` and ``hstart`` (L,) int32 are the continuous-history rows'
    (``continuous.py``): columns before ``hist`` are the 32 KiB history,
    match candidates but never tokens (their steps are 1, so the parse
    chain from column 0 lands on ``hist``), and columns before ``hstart``
    are row padding, neither. None: the whole row is the member."""
    q = _QUALITY[quality]
    families = [(family, q[k], q[w]) for family, k, w in _FAMILIES if k in q]
    prev = match_chain(match_keys(data, lengths, tuple(f for f, _k, _w in families), hstart))
    packs = match_bucket(prev, data, tuple(k for _f, k, _w in families), tuple(w for _f, _k, w in families))
    del prev
    q6 = packs[2] if len(families) == 3 else None
    return match_select(data, lengths, lazy, packs[0], packs[1], q6, hist, hstart)


def _finish_analysis_plain(data, use, dist, is_token):
    """Plain ``td_finish_analysis``: token selection -> symbols, extra bits
    and per-lane histograms, keyed as the reference's."""
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


def _flags_plain(a: dict) -> torch.Tensor:
    """K10's token flags of an analysis: is_token | is_match << 1, int32."""
    return a["is_token"].to(_I32) | (a["is_match"].to(_I32) << 1)


def _finish_analysis(data: torch.Tensor, use: torch.Tensor, dist: torch.Tensor, replay: torch.Tensor,
                     valid: torch.Tensor):
    """``td_finish_analysis``: the rows (L, S) uint8, the chosen runs and
    distances (L, S) int32, K9's replay bitmap and the match finder's mask
    (L, S) bool -> (the analysis dict of :func:`_finish_analysis_plain` on
    ``replay & valid``, K10's flags (L, S) int32); one kernel launch on the
    card."""
    _build.check_tensor("data", data, torch.uint8, 2)
    for name, t, dtype in (("use", use, _I32), ("dist", dist, _I32), ("replay", replay, torch.bool),
                           ("valid", valid, torch.bool)):
        _build.check_tensor(name, t, dtype, 2)
        _build.require(t.shape == data.shape, f"{name}: shape {tuple(t.shape)}, data {tuple(data.shape)}")
    if not _build.on_card(data, use, dist, replay, valid):
        a = _finish_analysis_plain(data, use, dist, replay & valid)
        return a, _flags_plain(a)
    L, S = data.shape
    dev = data.device
    is_token, is_match = (torch.empty((L, S), dtype=torch.bool, device=dev) for _ in range(2))
    fields = [torch.empty((L, S), dtype=_I32, device=dev) for _ in range(7)]
    hists = torch.zeros(L * (288 + 30), dtype=_I32, device=dev)
    litlen_hist, dist_hist = hists[: L * 288].view(L, 288), hists[L * 288 :].view(L, 30)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_finish_analysis(
            data.data_ptr(), use.data_ptr(), dist.data_ptr(), replay.data_ptr(), valid.data_ptr(),
            is_token.data_ptr(), is_match.data_ptr(), *(f.data_ptr() for f in fields), litlen_hist.data_ptr(),
            dist_hist.data_ptr(), L, S, _build.stream(dev))
    _build.check(err, "td_finish_analysis")
    ENCODE_LAUNCHES["finish_analysis"] += 1
    litlen_sym, len_eb, len_ev, dist_sym, dist_eb, dist_ev, flags = fields
    return {"is_token": is_token, "is_match": is_match, "litlen_sym": litlen_sym, "len_eb": len_eb,
            "len_ev": len_ev, "dist_sym": dist_sym, "dist_eb": dist_eb, "dist_ev": dist_ev,
            "litlen_hist": litlen_hist, "dist_hist": dist_hist}, flags


def analyze_phase1(data: torch.Tensor, lengths: torch.Tensor, lazy: bool = True, quality: int = 0,
                   hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Match find + the parse's tile transfer maps (K8)."""
    use, dist, step, valid = _match_find(data, lengths, lazy, quality, hist, hstart)
    tiles = pp.step_tiles(step)
    return {"use": use, "dist": dist, "tiles": tiles, "valid": valid,
            "transfers": pp.parse_transfers(tiles)}


def analyze_phase2(data, use, dist, tiles, valid, entries):
    """Replay the true chain (K9), then symbols and histograms ->
    (the analysis dict, K10's flags)."""
    return _finish_analysis(data, use, dist, pp.parse_replay(tiles, entries), valid)


def analyze_with_flags(data: torch.Tensor, lengths: torch.Tensor, lazy: bool = True, quality: int = 0,
                       hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """Both phases with the host walk between them -> (the analysis of one
    batch, K10's flags)."""
    p1 = analyze_phase1(data, lengths, lazy, quality, hist, hstart)
    entries = pp.host_entries(p1["transfers"].cpu().numpy())
    ent = torch.from_numpy(entries).to(data.device)
    return analyze_phase2(data, p1["use"], p1["dist"], p1["tiles"], p1["valid"], ent)


def analyze(data: torch.Tensor, lengths: torch.Tensor, lazy: bool = True, quality: int = 0,
            hist: torch.Tensor | None = None, hstart: torch.Tensor | None = None):
    """The analysis of one batch (:func:`analyze_with_flags`), keyed as
    ``encode_jax.analyze_device``'s (with the same ``hist``/``hstart``)."""
    return analyze_with_flags(data, lengths, lazy, quality, hist, hstart)[0]


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _fixed_code_tables() -> tuple[np.ndarray, np.ndarray]:
    fl = pack_codes(FIXED_LITLEN_LENGTHS[None, :].astype(np.int64), MAX_CODE_BITS)
    fd = pack_codes(FIXED_DIST_LENGTHS[None, :30].astype(np.int64), MAX_CODE_BITS)
    return fl, fd


def _plan_codes(a: dict, lengths: np.ndarray, final: np.ndarray | None = None) -> tuple:
    """Pull the histograms, plan lengths, codes and headers on the host and
    upload them at once. ``lengths`` are the bytes each lane codes (its
    stored cost), ``final`` (L,) 0/1 each lane's bfinal (None: all final).
    Returns the routing, code, header and EOB arguments of
    ``emit.emit_routed`` (on the histograms' device): the histograms, the
    planned lengths, the header's bits and the member lengths, the codes,
    header and EOB, the fixed tables and ``final`` (None or (L,) int64)."""
    with span("td.encode.plan"):
        with span("td.encode.pull"):
            ll_h, d_h = a["litlen_hist"].cpu().numpy(), a["dist_hist"].cpu().numpy()
        litlen_hist, dist_hist = fix_histograms(ll_h, d_h)
        ll_lengths = huffman_lengths_batch(litlen_hist, MAX_CODE_BITS)
        d_lengths = huffman_lengths_batch(dist_hist, MAX_CODE_BITS)
        ll_codes = pack_codes(ll_lengths, MAX_CODE_BITS)
        d_codes = pack_codes(d_lengths, MAX_CODE_BITS)
        header_vals, header_bits = build_headers(ll_lengths, d_lengths, final)
        with span("td.encode.enqueue"):
            plan = _upload(a["litlen_hist"].device, ll_lengths.astype(np.int32), d_lengths.astype(np.int32),
                           header_bits.sum(axis=1).astype(np.int32), np.asarray(lengths, np.int32), ll_codes,
                           d_codes, header_vals.astype(np.int64), header_bits,
                           (ll_codes[:, 256] & 0xFFFF).astype(np.int64), ll_codes[:, 256] >> 16,
                           *_fixed_code_tables(), *(() if final is None else (np.asarray(final, np.int64),)))
        return (a["litlen_hist"], a["dist_hist"], *plan[:12], plan[12] if len(plan) > 12 else None)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def _upload(devc: torch.device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Host int32/int64 arrays -> tensors of the same dtypes and shapes on
    ``devc``, views of one buffer that one copy uploads (each array at a
    16-byte boundary)."""
    offs, n = [], 0
    for x in arrays:
        offs.append(n)
        n += -(-x.nbytes // 16) * 16
    buf = np.zeros(n, np.uint8)
    for x, o in zip(arrays, offs):
        buf[o : o + x.nbytes] = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(devc)
    return [dev[o : o + x.nbytes].view(_TORCH_DTYPES[x.dtype]).view(x.shape) for x, o in zip(arrays, offs)]


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
    with span("td.encode.prep"):
        padded, lengths = _pad_batch(chunk)
    with span("td.encode.enqueue"):
        return _dispatch_staged(torch.from_numpy(padded).to(device), padded, lengths, lazy, quality)


def emit_inputs(pend, final: np.ndarray | None = None):
    """The host walk, phase 2 and planning of one dispatched batch ->
    (the arguments of ``emit.emit_routed``, the parse's step tiles, the
    entries). ``pend`` is (rows on the device, :func:`dispatch_phase1`'s
    three results, the caller's, the bytes each lane codes); ``final`` as
    :func:`_plan_codes` takes it."""
    dd, p1, host, done, _caller, lengths = pend
    if done is not None:
        with span("td.encode.pull"):
            done.synchronize()
    with span("td.encode.prep"):
        entries_h = pp.host_entries(host.numpy())
    with span("td.encode.enqueue"):
        entries = torch.from_numpy(entries_h).to(dd.device)
        a, flags = analyze_phase2(dd, p1["use"], p1["dist"], p1["tiles"], p1["valid"], entries)
    args = (a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"], a["dist_eb"],
            a["dist_ev"], *_plan_codes(a, lengths, final))
    return args, p1["tiles"], entries


def emit_batch(pend, final: np.ndarray | None = None) -> tuple:
    """:func:`emit_inputs`, then the emit with the routing in the same
    launch -> (words, total_bits, choice, dyn_bits, fixed_bits,
    stored_bits)."""
    args = emit_inputs(pend, final)[0]
    with span("td.encode.enqueue"):
        return em.emit_routed(*args)


def _plan_and_emit(pend):
    """Stage 2: :func:`emit_batch`."""
    words, total_bits, choice, *_costs = emit_batch(pend)
    dd, _p1, _host, _done, padded, lengths = pend
    return words, total_bits, choice, dd, padded, lengths


def _assemble_members(em) -> bytes:
    """Stage 3: member CRCs on the device, the words pulled up to the
    longest lane, members framed on the host."""
    words, total_bits, choice, dd, padded, lengths = em
    with span("td.encode.pull"):  # the CRC's launch and its read back, then the words
        crcs = crc32_members(dd, lengths)
        total_bits = total_bits.cpu().numpy()
        mw = min(words.shape[1], -(-int(total_bits.max()) // 32 // 512) * 512 or 512)
        payload_bytes = words[:, :mw].contiguous().cpu().numpy().view(np.uint8)
        choice = choice.cpu().numpy()
    out = bytearray()
    with span("td.encode.assemble"):
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
    with span("td.encode"):
        lazy = effort >= 2
        quality = 2 if effort >= 5 else (1 if effort >= 3 else 0)
        buf = np.frombuffer(data, dtype=np.uint8)
        step = ENC_LANE_BATCH * MEMBER_DATA
        chunks = [buf[base : base + step] for base in range(0, n, step)]
        parts = []
        run_pipeline(chunks, lambda c: _dispatch_analyze(c, lazy, quality, device), _plan_and_emit,
                     lambda em: parts.append(_assemble_members(em)))
        with span("td.encode.assemble"):
            return b"".join(parts)


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
