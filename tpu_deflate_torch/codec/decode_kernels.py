"""The decode wave's kernels: stage A (K1, which on the card first builds
each lane's decode tables with a kernel of its own, ``stage_a_tables``),
stage B (K2), stage C (the maps composed over tiles), stage DC (K3),
level-2 compaction (K4, with K7 as its no-map mode) and the host route's
packed token pull, which K4's pull mode does in the compaction's pass
(``compact_pack``; ``pack_tokens`` is the pull alone). K3's epilogue folds
its summary rows into the wave's per-lane vector (``wave_summary`` runs
that fold alone on given rows).

Each wrapper checks its inputs, then runs the hand-written CUDA kernel of
``tpu_deflate_torch/csrc/`` on CUDA tensors, or the plain PyTorch version
beside it on CPU tensors (``_build.on_card``). A CUDA tensor never reaches
a plain version: the kernel launches or the wrapper raises. ``LAUNCHES``
(``_build.LAUNCHES``) counts kernel launches per wrapper.

The plain versions are the readable spec and the CPU path. They mirror
the reference's integer semantics exactly: uint32 windows are held in
int64 masked to 32 bits, and shifts follow XLA (a count outside [0, 32)
gives 0). Layouts match the JAX package at every public function:
``stage_a`` (L, 512, NT), ``stage_b`` (L, NT, 48) uint8, ``stage_c``
entries (L, NT) uint8, ``stage_dc`` tokens (L, NT, k1), summary (L, 8,
NT) and the (7, L) vector.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .wave_prep import (
    _ERR_EMPTY_DIST,
    _ERR_END,
    _ERR_RESERVED_DIST,
    _ERR_RESERVED_LEN,
    E_WIN,
    MA_DEMPTY,
    MA_DNLIVE,
    MA_DPACK,
    MA_DPERM,
    MA_DSAT,
    MA_EOB,
    MA_INIT2,
    MA_INIT3,
    MA_LLNLIVE,
    MA_LLP2,
    MA_LLP3,
    MA_LLPACK,
    MA_LLSAT,
    MA_MW,
    MA_PBITS,
    META_W,
    ROW_COUNT,
    ROW_EOB_HIT,
    ROW_EOB_POS,
    ROW_EOB_TOK,
    ROW_ERR_HIT,
    ROW_ERR_TOK,
    ROW_OVERFLOW,
    ROW_SIZE_SUM,
    SENT_EOB,
    SENT_ERR,
    TOKEN_MATCH_BIT,
    W_P,
)

_EOB_ADV = 4096
_ERR_ADV = 8192
_M32 = 0xFFFFFFFF

# K1's decode tables (csrc/stage_a.cu): per lane TAB_N litlen entries then
# TAB_N distance entries, indexed by the next TAB_BITS stream bits in stream
# order (the ladder reads them reversed). Litlen entry: code length (bits
# 0-3), class K_* (bits 4-6, in the reference's order of precedence),
# payload (bits 16-31: literal rank, else match descriptor). Distance entry:
# code length (0-3), found (4), reserved symbol 30/31 (5), extra bits (6-9),
# distance base - 1 (16-31). E_LONG marks a prefix that the kernel decodes
# through the ladders.
TAB_BITS = 10
TAB_N = 1 << TAB_BITS
TAB_W = 2 * TAB_N
K_LIT, K_MATCH, K_EOB, K_RES, K_MISSING = range(5)
E_DFOUND, E_DRES = 1 << 4, 1 << 5
E_LONG = 1 << 15


# ---------------------------------------------------------------------------
# Stage A (K1)
# ---------------------------------------------------------------------------


def build_meta(w: dict) -> torch.Tensor:
    """Pack a wave's per-lane tables (tensors, from
    ``wave_prep.wave_to_tensors``) into the (L, META_W) int32 meta row of
    the stage-A kernel (``decode_pallas.build_meta``)."""
    ll_sat = w["ll_sat"].to(torch.int32)
    L = ll_sat.shape[0]
    scal = torch.stack(
        [
            w["ll_nlive"].to(torch.int32),
            w["d_nlive"].to(torch.int32),
            w["dist_empty"].to(torch.int32),
            w["payload_bits"].to(torch.int32),
            w["ll_eob"].to(torch.int32),
            w["ll_init2"].to(torch.int32),
            w["ll_init3"].to(torch.int32),
            torch.zeros(L, dtype=torch.int32, device=ll_sat.device),
        ],
        dim=1,
    )
    meta = torch.cat(
        [
            ll_sat,
            w["ll_pack"].to(torch.int32),
            w["ll_pack2"].to(torch.int32),
            w["ll_pack3"].to(torch.int32),
            w["d_sat"].to(torch.int32),
            w["d_pack"].to(torch.int32),
            scal,
            w["ll_mwords"].to(torch.int32),
            w["d_perm"].to(torch.int32),
        ],
        dim=1,
    )
    assert meta.shape[1] == MA_DPERM + 5
    return torch.nn.functional.pad(meta, (0, META_W - meta.shape[1])).contiguous()


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values to the int32 range (two's complement)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _shl(x: torch.Tensor, n) -> torch.Tensor:
    """uint32 left shift (x in [0, 2**32)); counts outside [0, 32) give 0."""
    n = torch.as_tensor(n, device=x.device)
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, (x << n.clamp(0, 31)) & _M32, 0)


def _shr(x: torch.Tensor, n) -> torch.Tensor:
    """uint32 logical right shift; counts outside [0, 32) give 0."""
    n = torch.as_tensor(n, device=x.device)
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, x >> n.clamp(0, 31), 0)


def _rev8(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55) << 1) | ((x >> 1) & 0x55)
    x = ((x & 0x33) << 2) | ((x >> 2) & 0x33)
    return ((x & 0x0F) << 4) | (x >> 4)


def _rev_low16(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Reverse the low k bits of x (0 <= x < 2**16, 0 <= k <= 16)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> (16 - k)


def _col(m: torch.Tensor, c: int, like: torch.Tensor) -> torch.Tensor:
    """Meta column c (signed int32 values in int64), broadcast per lane
    against ``like`` (lanes first)."""
    return m[:, c].view(-1, *([1] * (like.dim() - 1)))


def _ladder(m, v, sat_base, pack_base, nlive_col, extra=()):
    """Bounds-ladder decode of reversed windows v (uint32 in int64, lanes
    first): (code length, canonical index, found, the extra accumulators,
    mask of the passed thresholds whose step adds to an accumulator).
    ``extra`` holds (init column, pack base) pairs of accumulators riding
    the same compares."""
    acc = torch.zeros_like(v)
    mask = torch.zeros_like(v)
    accs = [_col(m, init, v).expand_as(v) for init, _ in extra]
    for l in range(1, 15):
        ge = v >= (_col(m, sat_base + l, v) & _M32)
        acc = torch.where(ge, acc + _col(m, pack_base + l, v), acc)
        accs = [torch.where(ge, a + _col(m, p + l, v), a) for a, (_, p) in zip(accs, extra)]
        moves = _col(m, pack_base + l, v) != 0
        for _, p in extra:
            moves = moves | (_col(m, p + l, v) != 0)
        mask = mask | ((ge & moves).to(torch.int64) << l)
    acc = wrap_int32(acc)
    cnt = acc >> 20
    ln = 1 + cnt
    off = (acc & 0xFFFFF) - (cnt << 16)
    idx = wrap_int32(_shr(v, 31 - cnt) + off)
    return ln, idx, idx < _col(m, nlive_col, v), accs, mask


def _litlen(m: torch.Tensor, vR: torch.Tensor) -> dict:
    """The litlen code of reversed windows vR through the class ladder
    (``wave_prep.class_ladder_tables``): code length, found, literal, EOB,
    reserved length, match, literal rank, match descriptor (run extra bits |
    run base - 3) and the mask of passed thresholds."""
    ln, lidx, lfound, (acc2, acc3), mask = _ladder(
        m, vR, MA_LLSAT, MA_LLPACK, MA_LLNLIVE, ((MA_INIT2, MA_LLP2), (MA_INIT3, MA_LLP3))
    )
    lnb = ln << 12
    lit_end = ((acc2 >> 16) & 0xFFFF) - lnb
    res_start = (acc2 & 0xFFFF) - lnb
    lit_off = ((acc3 >> 16) & 0xFFFF) - lnb
    mrank_off = (acc3 & 0xFFFF) - lnb

    is_lit = lfound & (lidx < lit_end)
    is_eob = lfound & (lidx == _col(m, MA_EOB, vR))
    reserved_len = lfound & (lidx >= res_start)
    is_match = lfound & ~is_lit & ~is_eob & ~reserved_len
    mrank = (lidx + mrank_off) & 31
    mdesc = torch.zeros_like(lidx)
    for bbit in range(11):
        mdesc = mdesc | (((_col(m, MA_MW + bbit, vR) & _M32) >> mrank) & 1) << bbit
    return {"ln": ln, "found": lfound, "lit": is_lit, "eob": is_eob, "res": reserved_len,
            "match": is_match, "lit_rank": lidx + lit_off, "mdesc": mdesc, "mask": mask}


def _dist(m: torch.Tensor, vD: torch.Tensor) -> dict:
    """The distance code of reversed windows vD: code length, found,
    distance symbol and the mask of passed thresholds."""
    dln, didx, dfound, _, mask = _ladder(m, vD, MA_DSAT, MA_DPACK, MA_DNLIVE)
    d5 = didx.clamp(min=0) & 31
    ds = torch.zeros_like(didx)
    for bbit in range(5):
        ds = ds | ((((_col(m, MA_DPERM + bbit, vD) & _M32) >> d5) & 1) << bbit)
    return {"ln": dln, "found": dfound, "ds": ds, "mask": mask}


def stage_a_plain(grid: torch.Tensor, meta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch stage A: grid (L, 64, NT+1) uint8, meta (L, 128)
    int32 -> (delta, token), both (L, 512, NT) int32. Position
    p = 512 t + s lives at [:, s, t]."""
    L, _, NTp = grid.shape
    NT = NTp - 1
    dev = grid.device
    m = meta.to(torch.int64)

    def col(c: int) -> torch.Tensor:  # signed int32 column, broadcast per lane
        return m[:, c].view(L, 1, 1)

    vR, vR2 = stage_a_windows(grid)
    c = _litlen(m, vR)
    ln, is_lit, is_eob, is_match = c["ln"], c["lit"], c["eob"], c["match"]
    run_bits = torch.where(is_match, c["mdesc"] & 7, 0)
    pay = c["mdesc"] >> 3  # run base - 3
    rev = _shr(vR, 32 - ln - run_bits)
    run = (pay + 3) + _rev_low16(rev & ((1 << run_bits) - 1), run_bits)
    d1 = ln + run_bits
    vD = _shl(vR, d1) | _shr(vR2, 32 - d1)

    d = _dist(m, vD)
    dln, ds = d["ln"], d["ds"]
    dist_bits = ((ds >> 1) - 1).clamp(min=0)
    reserved_dist = ds >= 30
    dbase_m1 = torch.where(ds < 4, ds, (2 + (ds & 1)) << dist_bits)
    drev = _shr(vD, 32 - dln - dist_bits)
    dist = dbase_m1 + 1 + _rev_low16(drev & ((1 << dist_bits) - 1), dist_bits)

    pos = torch.arange(W_P, device=dev).view(1, W_P, 1) + W_P * torch.arange(
        NT, device=dev
    ).view(1, 1, NT)
    bits = col(MA_PBITS)
    dist_empty = col(MA_DEMPTY) != 0
    end_len = pos + ln
    end_run = end_len + run_bits  # run_bits is 0 outside match positions
    end_dcode = end_run + dln
    end_all = end_dcode + dist_bits

    errc = torch.zeros_like(ln)
    for cond, code in (
        (~c["found"], _ERR_END),
        (end_len > bits, _ERR_END),
        (c["res"], _ERR_RESERVED_LEN),
        (is_match & (end_run > bits), _ERR_END),
        (is_match & dist_empty, _ERR_EMPTY_DIST),
        (is_match & ~d["found"], _ERR_END),
        (is_match & (end_dcode > bits), _ERR_END),
        (is_match & reserved_dist, _ERR_RESERVED_DIST),
        (is_match & (end_all > bits), _ERR_END),
    ):
        errc = torch.where((errc == 0) & cond, code, errc)

    adv = torch.where(is_match, end_all, end_len) - pos
    delta = torch.where(errc != 0, SENT_ERR, torch.where(is_eob, SENT_EOB, adv))
    token = torch.where(
        is_lit,
        c["lit_rank"],
        TOKEN_MATCH_BIT | (run.clamp(3, 258) << 16) | (dist - 1).clamp(0, 65535),
    )
    token = torch.where(is_eob, -(1 + ln), token)
    token = torch.where(errc != 0, -(100 + errc), token)
    return delta.to(torch.int32), wrap_int32(token).to(torch.int32)


def stage_a_windows(grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """grid (L, 64, NT+1) uint8 -> the reversed 32-bit windows (vR, vR2)
    at every position, (L, 512, NT) uint32 in int64: stream bit p at bit 31
    of vR, bit p+32 at bit 31 of vR2."""
    L, _, NTp = grid.shape
    NT = NTp - 1
    dev = grid.device
    g = _rev8(grid.to(torch.int64))
    q = torch.arange(64, device=dev)

    def brow(k: int) -> torch.Tensor:
        """(L, 64, NT): reversed byte q+k of tile t (spilling into t+1)."""
        rows = g[:, (q + k) & 63, :]
        spill = ((q + k) >> 6).view(1, 64, 1) == 1
        return torch.where(spill, rows[:, :, 1:], rows[:, :, :NT])

    b = [brow(k) for k in range(9)]
    u32a = ((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]).unsqueeze(2)
    u32b = ((b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]).unsqueeze(2)
    r = torch.arange(8, device=dev).view(1, 1, 8, 1)
    vR = (((u32a << r) & _M32) | (b[4].unsqueeze(2) >> (8 - r))).reshape(L, W_P, NT)
    vR2 = (((u32b << r) & _M32) | (b[8].unsqueeze(2) >> (8 - r))).reshape(L, W_P, NT)
    return vR, vR2


def stage_a_tables_plain(meta: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's table kernel: meta (L, 128) int32 -> (L,
    TAB_W) int32, the lane's TAB_N litlen entries then TAB_N distance
    entries (layout above), one per TAB_BITS-bit window prefix. An entry is
    short where the ladder passes the same thresholds (those whose step adds
    something) at the prefix's lowest and highest 32-bit window, so at every
    window between, and the code is at most TAB_BITS long; it then packs
    what the ladder gives. Every other entry is ``E_LONG``."""
    m = meta.to(torch.int64)
    L = m.shape[0]
    prefix = torch.arange(TAB_N, device=meta.device)
    lo = (prefix << (32 - TAB_BITS)).view(1, TAB_N).expand(L, TAB_N)
    hi = lo | ((1 << (32 - TAB_BITS)) - 1)

    a, b = _litlen(m, lo), _litlen(m, hi)
    lit_rank = wrap_int32(a["lit_rank"])
    payload = torch.where(a["lit"], lit_rank, a["mdesc"])
    ll_short = ((a["mask"] == b["mask"]) & (a["ln"] >= 1) & (a["ln"] <= TAB_BITS)
                & (~a["lit"] | ((lit_rank >= 0) & (lit_rank <= 0xFFFF))))
    kind = torch.where(~a["found"], K_MISSING, torch.where(
        a["res"], K_RES, torch.where(a["eob"], K_EOB, torch.where(a["lit"], K_LIT, K_MATCH))))
    ll = a["ln"] | (kind << 4) | (payload << 16)

    c, d = _dist(m, lo), _dist(m, hi)
    d_short = (c["mask"] == d["mask"]) & (c["ln"] >= 1) & (c["ln"] <= TAB_BITS)
    ds = c["ds"]
    dist_bits = ((ds >> 1) - 1).clamp(min=0)
    dbase_m1 = torch.where(ds < 4, ds, (2 + (ds & 1)) << dist_bits)
    dd = (c["ln"] | c["found"].to(torch.int64) * E_DFOUND | (ds >= 30).to(torch.int64) * E_DRES
          | (dist_bits << 6) | (dbase_m1 << 16))

    # Entry of reversed prefix i at the index of its bits in stream order.
    at = torch.zeros_like(prefix)
    for k in range(TAB_BITS):
        at |= ((prefix >> k) & 1) << (TAB_BITS - 1 - k)
    out = torch.empty((L, TAB_W), dtype=torch.int64, device=meta.device)
    out[:, at] = torch.where(ll_short, ll, E_LONG)
    out[:, TAB_N + at] = torch.where(d_short, dd, E_LONG)
    return wrap_int32(out).to(torch.int32)


def stage_a_tables(meta: torch.Tensor) -> torch.Tensor:
    """K1's table kernel: meta (L, 128) int32 -> decode tables (L, TAB_W)
    int32 (:func:`stage_a_tables_plain`)."""
    _build.check_tensor("meta", meta, torch.int32, 2)
    _build.require(meta.shape[1] == META_W, f"meta: shape {tuple(meta.shape)}")
    if not _build.on_card(meta):
        return stage_a_tables_plain(meta)
    L = meta.shape[0]
    tables = torch.empty((L, TAB_W), dtype=torch.int32, device=meta.device)
    lib = _build.load()
    with torch.cuda.device(meta.device):
        err = lib.td_stage_a_tables(meta.data_ptr(), tables.data_ptr(), L, _build.stream(meta.device))
    _build.check(err, "td_stage_a_tables")
    LAUNCHES["stage_a_tables"] += 1
    return tables


def stage_a(grid: torch.Tensor, meta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage A (K1): grid (L, 64, NT+1) uint8, meta (L, 128) int32 ->
    (delta, token), both (L, 512, NT) int32. On the card the lane's decode
    tables come first, from :func:`stage_a_tables`."""
    _build.check_tensor("grid", grid, torch.uint8, 3)
    _build.check_tensor("meta", meta, torch.int32, 2)
    L, WB, NTp = grid.shape
    _build.require(WB == 64 and NTp >= 2, f"grid: shape {tuple(grid.shape)}, expected (L, 64, NT+1)")
    _build.require(tuple(meta.shape) == (L, META_W), f"meta: shape {tuple(meta.shape)}")
    if not _build.on_card(grid, meta):
        return stage_a_plain(grid, meta)
    NT = NTp - 1
    tables = stage_a_tables(meta)
    delta = torch.empty((L, W_P, NT), dtype=torch.int32, device=grid.device)
    token = torch.empty_like(delta)
    lib = _build.load()
    with torch.cuda.device(grid.device):
        err = lib.td_stage_a(
            grid.data_ptr(), meta.data_ptr(), tables.data_ptr(), delta.data_ptr(),
            token.data_ptr(), L, NT,
            _ERR_END, _ERR_RESERVED_LEN, _ERR_EMPTY_DIST, _ERR_RESERVED_DIST,
            _build.stream(grid.device),
        )
    _build.check(err, "td_stage_a")
    LAUNCHES["stage_a"] += 1
    return delta, token


# ---------------------------------------------------------------------------
# Stage B (K2)
# ---------------------------------------------------------------------------


def _adv(delta: torch.Tensor) -> torch.Tensor:
    """Stage-A delta -> cursor advance (EOB/error jump far past the tile)."""
    return torch.where(delta == SENT_EOB, _EOB_ADV, torch.where(delta == SENT_ERR, _ERR_ADV, delta))


def stage_b_plain(delta_t: torch.Tensor) -> torch.Tensor:
    """Plain stage B: 48 cursors per tile in lock step over the 512 bit
    positions (a cursor moves when it stands on the current position)."""
    L, _, NT = delta_t.shape
    adv = _adv(delta_t.to(torch.int64))
    cur = torch.arange(E_WIN, device=delta_t.device).view(1, E_WIN, 1).expand(L, E_WIN, NT)
    for s in range(W_P):
        cur = cur + torch.where(cur == s, adv[:, s, :].unsqueeze(1), 0)
    out = torch.where(
        cur >= _ERR_ADV, SENT_ERR, torch.where(cur >= _EOB_ADV, SENT_EOB, (cur - W_P).clamp(0, 255))
    )
    return out.to(torch.uint8).permute(0, 2, 1).contiguous()


def stage_b(delta_t: torch.Tensor) -> torch.Tensor:
    """Stage B (K2): delta (L, 512, NT) int32 -> transfer maps (L, NT, 48)
    uint8 (exit offset into the next tile, or 127 / 255)."""
    _build.check_tensor("delta_t", delta_t, torch.int32, 3)
    L, W, NT = delta_t.shape
    _build.require(W == W_P, f"delta_t: shape {tuple(delta_t.shape)}, expected (L, 512, NT)")
    if not _build.on_card(delta_t):
        return stage_b_plain(delta_t)
    out = torch.empty((L, NT, E_WIN), dtype=torch.uint8, device=delta_t.device)
    lib = _build.load()
    with torch.cuda.device(delta_t.device):
        err = lib.td_stage_b(delta_t.data_ptr(), out.data_ptr(), L, NT, _build.stream(delta_t.device))
    _build.check(err, "td_stage_b")
    LAUNCHES["stage_b"] += 1
    return out


# ---------------------------------------------------------------------------
# Stage C
# ---------------------------------------------------------------------------


def stage_c_plain(transfers: torch.Tensor, entry0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain stage C: compose the per-tile transfer maps over tiles.

    transfers (L, NT, 48) uint8 with values in [0, 48) or a sentinel
    (>= 127, passed through unchanged), as stage B produces them; entry0
    (L,) in [0, 48). Returns the entry offset of every tile (L, NT) uint8
    and the final state (L,) uint8: 127 (clean EOB), 255 (error) or an
    offset (ran off the payload). A value of 48..126 is outside a map's
    domain and becomes 255. An inclusive Hillis-Steele scan over the tile
    axis composes maps with ``torch.gather`` (log2(NT) levels).
    """
    L, NT, E = transfers.shape
    assert E == E_WIN
    x = transfers.to(torch.int64)

    def apply(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """f[v] per lane and tile; sentinels pass through, and a value
        outside the map's domain is an error."""
        got = f.gather(-1, v.clamp(0, E - 1))
        return torch.where(v >= SENT_EOB, v, torch.where(v < E, got, SENT_ERR))

    s = 1
    while s < NT:
        # prefix[t] = prefix[t - s] then prefix[t]
        x = torch.cat([x[:, :s], apply(x[:, s:], x[:, :-s])], dim=1)
        s *= 2
    e0 = entry0.to(torch.int64).view(L, 1, 1).expand(L, NT, 1)
    applied = apply(x, e0).view(L, NT)
    entries = torch.cat([entry0.to(torch.int64).view(L, 1), applied[:, :-1]], dim=1)
    return entries.to(torch.uint8), applied[:, -1].to(torch.uint8)


STAGE_C_THREADS = 128  # threads a block of csrc/stage_c.cu
STAGE_C_MIN_SEGMENT, STAGE_C_MAX_SEGMENT = 16, 512  # tiles a block of csrc/stage_c.cu
STAGE_C_LOOK = 32  # predecessors a look-back round of csrc/stage_c.cu reads
STAGE_C_BLOCKS = 96  # the most blocks a wave is cut into while segments can grow


def stage_c_segment(L: int, NT: int) -> int:
    """Tiles a block of ``csrc/stage_c.cu`` takes: the smallest power of two
    from ``STAGE_C_MIN_SEGMENT`` up to ``STAGE_C_MAX_SEGMENT`` that leaves a
    lane at most ``STAGE_C_LOOK`` segments (a look-back then reads every
    predecessor in one round) and the wave at most ``STAGE_C_BLOCKS``, never
    more than NT. A one-lane wave of a few hundred to a few thousand tiles
    gets 17 to 32 blocks, the main path's 256-lane waves one a lane.
    Measured on the H100 (``scripts/stage_c_segments.py``): shorter
    segments spread a wave wider, but their look-backs take more rounds,
    and past ~100 blocks that costs more than the SMs it fills."""
    seg = STAGE_C_MIN_SEGMENT
    while seg < STAGE_C_MAX_SEGMENT and (-(-NT // seg) > STAGE_C_LOOK or L * -(-NT // seg) > STAGE_C_BLOCKS):
        seg *= 2
    return min(seg, NT)


def stage_c(transfers: torch.Tensor, entry0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage C: transfer maps (L, NT, 48) uint8, entry0 (L,) int32 ->
    (entries (L, NT) uint8, final state (L,) uint8, the entries as int32,
    the form K3 takes); one launch of ``csrc/stage_c.cu`` on the card, a
    block a segment of :func:`stage_c_segment` tiles."""
    _build.check_tensor("transfers", transfers, torch.uint8, 3)
    _build.check_tensor("entry0", entry0, torch.int32, 1)
    L, NT, E = transfers.shape
    _build.require(E == E_WIN, f"transfers: shape {tuple(transfers.shape)}, expected (L, NT, {E_WIN})")
    _build.require(entry0.shape[0] == L, f"entry0: shape {tuple(entry0.shape)}")
    if not _build.on_card(transfers, entry0):
        entries, final = stage_c_plain(transfers, entry0)
        return entries, final, entries.to(torch.int32)
    dev = transfers.device
    entries = torch.empty((L, NT), dtype=torch.uint8, device=dev)
    entries32 = torch.empty((L, NT), dtype=torch.int32, device=dev)
    final = torch.empty(L, dtype=torch.uint8, device=dev)
    seg = stage_c_segment(L, NT)
    # Each (lane, segment)'s published map (48 bytes: 6 int64) and status
    # word, then the segments' ticket counter.
    scratch = torch.zeros(L * -(-NT // seg) * 7 + 1, dtype=torch.int64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_stage_c(transfers.data_ptr(), entry0.data_ptr(), entries.data_ptr(), entries32.data_ptr(),
                             final.data_ptr(), scratch.data_ptr(), L, NT, seg, _build.stream(dev))
    _build.check(err, "td_stage_c")
    LAUNCHES["stage_c"] += 1
    return entries, final, entries32


# ---------------------------------------------------------------------------
# Stage DC (K3)
# ---------------------------------------------------------------------------


def stage_dc_plain(
    delta_t: torch.Tensor, token_t: torch.Tensor, entries: torch.Tensor, k1: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain stage DC: lock-step replay from each tile's entry, then the
    summary rows and a scatter of the first k1 reached tokens."""
    L, _, NT = delta_t.shape
    dev = delta_t.device
    d = delta_t.to(torch.int64)
    tok = token_t.to(torch.int64)
    adv = _adv(d)
    e = entries.to(torch.int64)
    cur = torch.where(e < E_WIN, e, 100000)
    reached = torch.zeros((L, W_P, NT), dtype=torch.bool, device=dev)
    for s in range(W_P):
        at = cur == s
        reached[:, s, :] = at
        cur = cur + torch.where(at, adv[:, s, :], 0)

    is_eob = reached & (d == SENT_EOB)
    is_err = reached & (d == SENT_ERR)
    valid = reached & (d < SENT_EOB)
    pos = torch.arange(W_P, device=dev).view(1, W_P, 1)
    is_lit = (tok >= 0) & (tok < 256)
    size = torch.where(is_lit, 1, (tok >> 16) & 0x3FF)
    counts = valid.sum(dim=1)
    summary = torch.stack(
        [
            counts,
            (is_eob * pos).sum(dim=1),
            (is_eob * tok).sum(dim=1),
            (is_err * tok).sum(dim=1),
            (valid * size).sum(dim=1),
            is_eob.sum(dim=1),
            is_err.sum(dim=1),
            (counts > k1).to(torch.int64),
        ],
        dim=1,
    )
    rank = valid.cumsum(dim=1) - 1
    slot = torch.where(valid & (rank < k1), rank, k1)  # slot k1 collects the rest
    out = torch.full((L, k1 + 1, NT), -1, dtype=torch.int64, device=dev)
    out.scatter_(1, slot, torch.where(valid, tok, -1))
    out[:, k1, :] = -1
    tokens = out[:, :k1, :].permute(0, 2, 1).contiguous()
    return tokens.to(torch.int32), wrap_int32(summary).to(torch.int32)


FOLD_WORDS = 16  # int64 counts of the summary fold a lane (csrc/stage_dc.cu's FOLD_STRIDE)


def stage_dc(
    delta_t: torch.Tensor, token_t: torch.Tensor, entries: torch.Tensor, *, k1: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage DC (K3): delta/token (L, 512, NT) int32, entries (L, NT) int32
    (>= 48 is a dead tile) -> (tokens (L, NT, k1) int32 with -1 padding,
    summary (L, 8, NT) int32, the wave's (7, L) int32 vector of
    :func:`wave_summary` with row 6 (nlit) 0). On the card one launch: the
    summary fold is K3's epilogue (its scratch kept zeroed between calls,
    ``_build.kept_zero``); on the CPU :func:`stage_dc_plain` and
    :func:`wave_summary_plain`."""
    _build.check_tensor("delta_t", delta_t, torch.int32, 3)
    _build.check_tensor("token_t", token_t, torch.int32, 3)
    _build.check_tensor("entries", entries, torch.int32, 2)
    L, W, NT = delta_t.shape
    _build.require(W == W_P, f"delta_t: shape {tuple(delta_t.shape)}, expected (L, 512, NT)")
    _build.require(token_t.shape == delta_t.shape, f"token_t: shape {tuple(token_t.shape)}")
    _build.require(tuple(entries.shape) == (L, NT), f"entries: shape {tuple(entries.shape)}")
    _build.require(1 <= k1 <= W_P, f"k1={k1} outside [1, {W_P}]")
    if not _build.on_card(delta_t, token_t, entries):
        tokens, summ = stage_dc_plain(delta_t, token_t, entries, k1)
        return tokens, summ, wave_summary_plain(summ)
    dev = delta_t.device
    tokens = torch.empty((L, NT, k1), dtype=torch.int32, device=dev)
    summ = torch.empty((L, 8, NT), dtype=torch.int32, device=dev)
    vec = torch.empty((7, L), dtype=torch.int32, device=dev)
    counts = _build.kept_zero("wave_fold", dev, FOLD_WORDS * (L + 1))
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_stage_dc(
            delta_t.data_ptr(), token_t.data_ptr(), entries.data_ptr(), tokens.data_ptr(),
            summ.data_ptr(), vec.data_ptr(), counts.data_ptr(), L, NT, k1, _build.stream(dev),
        )
    if err:
        _build.drop_kept_zero("wave_fold", dev)
    _build.check(err, "td_stage_dc")
    LAUNCHES["stage_dc"] += 1
    return tokens, summ, vec


# ---------------------------------------------------------------------------
# The wave's summary fold (K3's summary rows -> the per-lane vector)
# ---------------------------------------------------------------------------


def wave_sums_plain(summ: torch.Tensor):
    """The reference wave body's per-lane results from K3's summary rows
    (L, 8, NT) int32: (counts, has_eob bool, eob_exit, err_code, out_total,
    each (L,) int32, and overflow, a bool over the whole wave)."""
    NT = summ.shape[2]
    counts = summ[:, ROW_COUNT, :].sum(dim=1)
    eob_hit = summ[:, ROW_EOB_HIT, :]
    has_eob = eob_hit.sum(dim=1) > 0
    tile_base = (torch.arange(NT, device=summ.device) * W_P).view(1, NT)
    eob_pos = (summ[:, ROW_EOB_POS, :] + eob_hit * tile_base).sum(dim=1)
    eob_tok = summ[:, ROW_EOB_TOK, :].sum(dim=1)
    eob_exit = torch.where(has_eob, eob_pos + (-eob_tok - 1), 0)
    err_hit = summ[:, ROW_ERR_HIT, :].sum(dim=1) > 0
    err_tok = summ[:, ROW_ERR_TOK, :].sum(dim=1)
    err_code = torch.where(err_hit, -err_tok - 100, 0)
    out_total = summ[:, ROW_SIZE_SUM, :].sum(dim=1)
    overflow = summ[:, ROW_OVERFLOW, :].sum() > 0
    i32 = torch.int32
    return counts.to(i32), has_eob, eob_exit.to(i32), err_code.to(i32), out_total.to(i32), overflow


def pack_small(counts, has_eob, eob_exit, err_code, out_total, overflow, nlit=None):
    """Stack a wave's per-lane results into one (7, L) int32 tensor, so the
    host pulls one array instead of seven."""
    L = counts.shape[0]
    if nlit is None:
        nlit = torch.zeros(L, dtype=torch.int32, device=counts.device)
    return torch.stack(
        [
            counts.to(torch.int32),
            has_eob.to(torch.int32),
            eob_exit.to(torch.int32),
            err_code.to(torch.int32),
            out_total.to(torch.int32),
            overflow.to(torch.int32).expand(L),
            nlit.to(torch.int32),
        ]
    )


def wave_summary_plain(summ: torch.Tensor, nlit: torch.Tensor | None = None) -> torch.Tensor:
    """Plain summary fold: :func:`pack_small` of :func:`wave_sums_plain`."""
    return pack_small(*wave_sums_plain(summ), nlit=nlit)


def wave_summary(summ: torch.Tensor, nlit: torch.Tensor | None = None) -> torch.Tensor:
    """Summary rows (L, 8, NT) int32 -> the wave's (7, L) int32 vector of
    :func:`pack_small`: counts, has_eob, eob_exit, err_code, out_total,
    overflow (the whole wave's, in every lane) and ``nlit`` (L,) int32 (0
    without it). The decode takes this vector from K3 (:func:`stage_dc`),
    whose epilogue folds it; this runs the same epilogue on given rows (one
    32-thread block a strip of K3's, ``csrc/stage_dc.cu``'s
    ``wave_fold_kernel``), so that any rows can check it."""
    _build.check_tensor("summ", summ, torch.int32, 3)
    L, R, NT = summ.shape
    _build.require(R == 8, f"summ: shape {tuple(summ.shape)}, expected (L, 8, NT)")
    if nlit is not None:
        _build.check_tensor("nlit", nlit, torch.int32, 1)
        _build.require(nlit.shape[0] == L, f"nlit: shape {tuple(nlit.shape)}, expected ({L},)")
    if not _build.on_card(summ, *([] if nlit is None else [nlit])):
        return wave_summary_plain(summ, nlit)
    dev = summ.device
    out = torch.empty((7, L), dtype=torch.int32, device=dev)
    counts = _build.kept_zero("wave_fold", dev, FOLD_WORDS * (L + 1))
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_wave_summary(summ.data_ptr(), None if nlit is None else nlit.data_ptr(), out.data_ptr(),
                                  counts.data_ptr(), L, NT, _build.stream(dev))
    if err:
        _build.drop_kept_zero("wave_fold", dev)
    _build.check(err, "td_wave_summary")
    LAUNCHES["wave_summary"] += 1
    return out


# ---------------------------------------------------------------------------
# Level-2 compaction (K4; K7 is its no-map mode; the packed pull its pull
# mode)
# ---------------------------------------------------------------------------

COMPACT_MIN_SEGMENT = 1024  # entries of the smaller segment of csrc/compact.cu


def map_literals_plain(tok: torch.Tensor, lit_planes: torch.Tensor) -> torch.Tensor:
    """Literal rank (< 256) -> byte through the lane's 8 bit planes."""
    is_l = (tok >= 0) & (tok < 256)
    r8 = torch.where(is_l, tok, 0).to(torch.int64)
    wsel = r8 >> 5
    lo5 = r8 & 31
    planes = lit_planes.to(torch.int64) & _M32
    byte = torch.zeros_like(r8)
    for b in range(8):
        word = planes.gather(1, b * 8 + wsel)
        byte = byte | (((word >> lo5) & 1) << b)
    return torch.where(is_l, byte.to(tok.dtype), tok)


def compact_plain(tok: torch.Tensor, lit_planes: torch.Tensor | None) -> torch.Tensor:
    """Plain compaction: a stable sort puts the non-negative entries first,
    -1 fills the rest; literal ranks map to bytes when planes are given."""
    valid = tok >= 0
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    front = tok.gather(1, order)
    n = valid.sum(dim=1, keepdim=True)
    out = torch.where(torch.arange(tok.shape[1], device=tok.device).view(1, -1) < n, front, -1)
    return out if lit_planes is None else map_literals_plain(out, lit_planes)


def _compact(tok: torch.Tensor, lit_planes: torch.Tensor | None) -> torch.Tensor:
    _build.check_tensor("tok", tok, torch.int32, 2)
    L, M = tok.shape
    if lit_planes is not None:
        _build.check_tensor("lit_planes", lit_planes, torch.int32, 2)
        _build.require(tuple(lit_planes.shape) == (L, 64), f"lit_planes: shape {tuple(lit_planes.shape)}")
    on_card = _build.on_card(tok) if lit_planes is None else _build.on_card(tok, lit_planes)
    if not on_card:
        return compact_plain(tok, lit_planes)
    out = torch.empty_like(tok)
    # Each (lane, segment)'s look-back status word, then the segments'
    # ticket counter, sized for the smallest segment.
    scratch = torch.zeros(L * -(-M // COMPACT_MIN_SEGMENT) + 1, dtype=torch.int64, device=tok.device)
    lib = _build.load()
    with torch.cuda.device(tok.device):
        err = lib.td_compact(
            tok.data_ptr(), 0 if lit_planes is None else lit_planes.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), L, M, int(lit_planes is not None), _build.stream(tok.device),
        )
    _build.check(err, "td_compact")
    LAUNCHES["compact_flat" if lit_planes is not None else "compact_any"] += 1
    return out


def compact_flat(tok: torch.Tensor, lit_planes: torch.Tensor) -> torch.Tensor:
    """K4: front-compact each lane's (L, M) int32 tokens (-1 padding) and
    map literal ranks to bytes through lit_planes (L, 64) int32."""
    return _compact(tok, lit_planes)


def compact_any(tok: torch.Tensor) -> torch.Tensor:
    """K7: front-compact each lane's non-negative entries (-1 padding)."""
    return _compact(tok, None)


# Entries of a pull segment where the wave is small (the 1024-entry
# segments of csrc/compact.cu); the scratch is sized for them.
PULL_MIN_SEGMENT = 1024


def pack_tokens_plain(tokens: torch.Tensor):
    """Plain packed pull (``decode_jax_v2._pack_tokens_jit``): the literals
    and the matches each front-compacted by K7 (``compact_any``), the
    literal bitmap by shifts and a sum, ``nlit`` by a sum."""
    L, M = tokens.shape
    is_lit = (tokens >= 0) & (tokens < 256)
    is_match = tokens >= 256
    lit_c = compact_any(torch.where(is_lit, tokens, -1))
    match_c = compact_any(torch.where(is_match, tokens, -1))
    Mw = -(-M // 32)
    bits = torch.nn.functional.pad(is_lit.to(torch.int64), (0, Mw * 32 - M))
    shifts = torch.arange(32, device=tokens.device).view(1, 1, 32)
    words = (bits.view(L, Mw, 32) << shifts).sum(dim=2)
    bitmap = wrap_int32(words).to(torch.int32)
    nlit = is_lit.sum(dim=1).to(torch.int32)
    return bitmap, lit_c.to(torch.uint8), match_c, nlit


def _pull(tok: torch.Tensor, lit_planes: torch.Tensor | None, nlit: torch.Tensor):
    """One launch of csrc/compact.cu's pull mode (``td_compact_pull``) into
    new bitmap, lit and match tensors and the given nlit (L,) int32. Its
    look-back scratch comes in two halves that calls on a stream take in
    turn, each call zeroing the one the call before it used
    (``_build.alternating_halves``), so the launch needs no fill."""
    L, M = tok.shape
    dev = tok.device
    bitmap = torch.empty((L, -(-M // 32)), dtype=torch.int32, device=dev)
    lit = torch.empty((L, M), dtype=torch.uint8, device=dev)
    match = torch.empty((L, M), dtype=torch.int32, device=dev)
    scratch, other, dirty = _build.alternating_halves("compact_pull", dev, L * -(-M // PULL_MIN_SEGMENT) + 1)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_compact_pull(tok.data_ptr(), None if lit_planes is None else lit_planes.data_ptr(),
                                  bitmap.data_ptr(), lit.data_ptr(), match.data_ptr(), nlit.data_ptr(),
                                  scratch.data_ptr(), other.data_ptr(), dirty, L, M, _build.stream(dev))
    if err:
        _build.drop_kept_zero("compact_pull", dev)
    _build.check(err, "td_compact_pull")
    return bitmap, lit, match


def pack_tokens(tokens: torch.Tensor):
    """Split a wave's front-compacted tokens (L, M) int32 for the pull:
    literals as 1 byte, matches as 4, and the order as a 1-bit map.

    Returns (bitmap (L, ceil(M/32)) int32 [bit k of word w = token 32w+k
    is a literal], lit (L, M) uint8 [the literals, then 255], match (L, M)
    int32 [the matches, then -1], nlit (L,) int32); tokens below 0 are in
    neither stream. On the card one launch of K4's pull mode with the map
    off (``td_compact_pull``; the host route runs it with the map on,
    :func:`compact_pack`); on the CPU :func:`pack_tokens_plain`."""
    _build.check_tensor("tokens", tokens, torch.int32, 2)
    if not _build.on_card(tokens):
        return pack_tokens_plain(tokens)
    nlit = torch.empty(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    bitmap, lit, match = _pull(tokens, None, nlit)
    LAUNCHES["pack_tokens"] += 1
    return bitmap, lit, match, nlit


def compact_pack_plain(tok: torch.Tensor, lit_planes: torch.Tensor):
    """Plain K4 and pull in one: :func:`pack_tokens_plain` of
    :func:`compact_plain` (the route's two steps before the fold)."""
    return pack_tokens_plain(compact_plain(tok, lit_planes))


def compact_pack(tok: torch.Tensor, lit_planes: torch.Tensor, small: torch.Tensor):
    """K4 and the packed pull in one pass (the host route's wave): K3's
    tokens (L, M) int32 with their padding in place and the lane's literal
    planes (L, 64) int32 -> (bitmap, lit, match, nlit) of
    :func:`pack_tokens` applied to :func:`compact_flat`'s output, with
    ``nlit`` written into row 6 of K3's (7, L) int32 vector ``small`` (the
    returned nlit is that row). On the card one launch of
    ``td_compact_pull`` with the map on (and the bitmap's memset); on the
    CPU :func:`compact_pack_plain`."""
    _build.check_tensor("tok", tok, torch.int32, 2)
    _build.check_tensor("lit_planes", lit_planes, torch.int32, 2)
    _build.check_tensor("small", small, torch.int32, 2)
    L = tok.shape[0]
    _build.require(tuple(lit_planes.shape) == (L, 64), f"lit_planes: shape {tuple(lit_planes.shape)}")
    _build.require(tuple(small.shape) == (7, L), f"small: shape {tuple(small.shape)}, expected (7, {L})")
    if not _build.on_card(tok, lit_planes, small):
        bitmap, lit, match, nlit = compact_pack_plain(tok, lit_planes)
        small[6] = nlit
        return bitmap, lit, match, small[6]
    bitmap, lit, match = _pull(tok, lit_planes, small[6])
    LAUNCHES["compact_pack"] += 1
    return bitmap, lit, match, small[6]
