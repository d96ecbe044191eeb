"""Device LZ77 resolve: tokens -> final bytes (counterpart of
``tpu_deflate.codec.resolve_pallas``).

Two kernels per 64 KiB output tile:

1. **expand** (K5, ``csrc/expand.cu``): a lane's front-compacted token
   stream -> per-position state: the literal byte (``y0``) or the match's
   *source position* (``src``) in the capped region-mod form. For p inside
   a maximal constant-distance region starting at A, ``out[p] = out[p-d]``
   iterates to ``src(p) = p - k d`` with ``k = max(min((p-A)//d + 1,
   32768//d), 1)``: RLE runs and periodic copies collapse to a short
   chain, and every source stays within 32 KiB of its position.
2. **sweep** (K6, ``csrc/sweep.cu``): follows each position's ``src``
   chain to a literal or into the previous tile's 32 KiB resolved tail.

Public layouts are the reference's: tokens ``(L, N_POS)`` int32 with -1
padding; ``y0``/``src`` ``(L, N_POS)`` int32; the summary ``(L, 8)``
int32 holds row 0 the first copy-before-start / oversized-distance
position (``N_POS`` if none), row 1 the total output, row 2 the match
positions left to resolve and (after :func:`resolve_tokens_device`) row 3
the unresolved residue; ``y`` ``(L, N_POS)`` int32 bytes with zero tails.
A lane with a residue or an error position goes back to the host resolve.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch
version (the readable spec, also the CPU path) on CPU tensors.

Where the TPU kernel differs: it places token records with log-shift
displacement moves over 17 bits, which equal a plain scatter to each
token's start whenever every start minus its slot index is below 2**17
(always for a stream of at most 64 KiB). Past that, only for corrupt
streams that encode far more than 64 KiB in one tile, its moves may drop
records; the port scatters exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._build import LAUNCHES
from ..kernels import checksum_lanes as cl

N_POS = 65536  # tile output space
TOKEN_MATCH_BIT = 1 << 26
W_CAP = 32768  # largest emitted back-jump: the DEFLATE window
TAIL_ROWS = 256  # the reference's tail layout: 256 rows of 128
TAIL = TAIL_ROWS * 128  # 32 KiB of resolved history ahead of a tile
_SWEEP_MAX_ROUNDS = 19  # plain sweep: pointer doubling over 96 KiB, plus one


# ---------------------------------------------------------------------------
# K5 expand
# ---------------------------------------------------------------------------


def expand_plain(
    tokens: torch.Tensor, hist: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain expand: tokens (L, M) int32 -> (y0, src, summary (L, 8))."""
    L, M = tokens.shape
    dev = tokens.device
    x = tokens.to(torch.int64)
    is_m = x >= 256
    sizes = torch.where(x >= 0, torch.where(is_m, (x >> 16) & 0x3FF, 1), 0)
    incl = sizes.cumsum(1)
    total = incl[:, -1]
    starts = incl - sizes
    # Each token's record at its start position (starts >= M dropped).
    placed = (sizes > 0) & (starts < M)
    rec = torch.full((L, M + 1), -1, dtype=torch.int64, device=dev)
    rec.scatter_(1, torch.where(placed, starts, M), torch.where(placed, x, -1))
    rec = rec[:, :M]

    pos = torch.arange(M, device=dev).view(1, M)
    in_stream = pos < total.view(L, 1)
    has = rec >= 0
    lit_here = has & (rec < 256)
    mstart = rec >= 256
    # dist-1 >= 0x8000 cannot come from a valid stream: an error at the
    # match start. The per-position distance keeps 15 bits.
    big_dist = mstart & ((rec & 0xFFFF) >= 0x8000)
    # Per-position distance: the covering record's, by a running max of
    # (pos << 15 | d - 1) over record positions.
    packed = torch.where(mstart, (pos << 15) | (rec & 0x7FFF), torch.where(has, pos << 15, -1))
    packed = packed.cummax(1).values
    match_pos = in_stream & ~lit_here
    cd = torch.where(match_pos, (packed & 0x7FFF) + 1, 0)
    prev = torch.nn.functional.pad(cd, (1, 0), value=-1)[:, :M]
    brk = (cd != prev) | (cd == 0)  # a literal always breaks a region
    A = torch.where(brk, pos, -1).cummax(1).values
    i = pos - A
    dd = cd.clamp(min=1)
    q = torch.div(i, dd, rounding_mode="floor")
    src_mod = A - dd + (i - q * dd)  # the uncapped source: does the chain leave the history?
    k = torch.minimum(q + 1, W_CAP // dd).clamp(min=1)
    src = torch.where(match_pos, pos - k * dd, pos)

    err = (match_pos & (src_mod < -hist)) | (in_stream & big_dist)
    y0 = torch.where(lit_here & in_stream, rec & 0xFF, torch.where(in_stream & ~err, -1, 0))
    src = torch.where(err, pos, src)
    summ = torch.zeros((L, 8), dtype=torch.int64, device=dev)
    summ[:, 0] = torch.where(err, pos, M).amin(1)
    summ[:, 1] = total
    summ[:, 2] = (match_pos & ~err).sum(1)
    i32 = torch.int32
    return y0.to(i32), src.to(i32), summ.to(i32)


def expand(
    tokens: torch.Tensor, *, hist: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: tokens (L, N_POS) int32 -> (y0, src, summary (L, 8)). ``hist``
    is the resolved history before position 0: 0 at a stream start,
    32768 for a chained tile."""
    _build.check_tensor("tokens", tokens, torch.int32, 2)
    L, M = tokens.shape
    _build.require(M == N_POS, f"tokens: shape {tuple(tokens.shape)}, expected (L, {N_POS})")
    _build.require(hist in (0, TAIL), f"hist={hist}: expected 0 or {TAIL}")
    if not _build.on_card(tokens):
        return expand_plain(tokens, hist)
    dev = tokens.device
    y0 = torch.empty_like(tokens)
    src = torch.empty_like(tokens)
    summ = torch.empty((L, 8), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_expand(
            tokens.data_ptr(), y0.data_ptr(), src.data_ptr(), summ.data_ptr(), L, hist,
            _build.stream(dev),
        )
    _build.check(err, "td_expand")
    LAUNCHES["expand"] += 1
    return y0, src, summ


# ---------------------------------------------------------------------------
# K6 sweep
# ---------------------------------------------------------------------------


def sweep_plain(
    tail: torch.Tensor, y0: torch.Tensor, src: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain sweep: pointer doubling over [tail | tile] until every
    position holds a byte. Returns (y (L, M) int32, status (L, 8) int32:
    row 0 residue, row 1 rounds)."""
    L, M = y0.shape
    state = torch.cat(  # >= 0: resolved byte; < 0: -(1 + index of the source)
        [tail.to(torch.int64), torch.where(y0 >= 0, y0, -1 - (src + TAIL)).to(torch.int64)], 1
    )
    rounds = 0
    while rounds < _SWEEP_MAX_ROUNDS and bool((state < 0).any()):
        ptr = (-1 - state).clamp(0, state.shape[1] - 1)
        state = torch.where(state < 0, state.gather(1, ptr), state)
        rounds += 1
    tile = state[:, TAIL:]
    unres = tile < 0
    status = torch.zeros((L, 8), dtype=torch.int32, device=y0.device)
    status[:, 0] = unres.sum(1).to(torch.int32)
    status[:, 1] = rounds
    return torch.where(unres, 0, tile).to(torch.int32), status


def sweep(
    tail: torch.Tensor, y0: torch.Tensor, src: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: tail (L, 32768) int32 resolved bytes, y0/src (L, N_POS) int32
    from :func:`expand` -> (y (L, N_POS) int32, status (L, 8) int32). Row 0
    of the status is the residue (positions left unresolved, their y is
    0); row 1 counts rounds, a diagnostic that differs by method."""
    _build.check_tensor("tail", tail, torch.int32, 2)
    _build.check_tensor("y0", y0, torch.int32, 2)
    _build.check_tensor("src", src, torch.int32, 2)
    L, M = y0.shape
    _build.require(M == N_POS, f"y0: shape {tuple(y0.shape)}, expected (L, {N_POS})")
    _build.require(src.shape == y0.shape, f"src: shape {tuple(src.shape)}")
    _build.require(tuple(tail.shape) == (L, TAIL), f"tail: shape {tuple(tail.shape)}")
    if not _build.on_card(tail, y0, src):
        return sweep_plain(tail, y0, src)
    dev = y0.device
    y = torch.empty_like(y0)
    status = torch.empty((L, 8), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_sweep(
            tail.data_ptr(), y0.data_ptr(), src.data_ptr(), y.data_ptr(), status.data_ptr(), L,
            _build.stream(dev),
        )
    _build.check(err, "td_sweep")
    LAUNCHES["sweep"] += 1
    return y, status


def resolve_tokens_device(
    tokens: torch.Tensor, *, tail: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full resolve of (L, N_POS) int32 tokens on their device: expand,
    then sweep against ``tail`` (L, 32768) int32 resolved history (None =
    stream start). Returns (y (L, N_POS) int32 bytes, summary (L, 8) with
    the sweep's residue in row 3)."""
    L = tokens.shape[0]
    hist = 0 if tail is None else TAIL
    y0, src, summ = expand(tokens, hist=hist)
    if tail is None:
        tail = torch.zeros((L, TAIL), dtype=torch.int32, device=tokens.device)
    y, status = sweep(tail, y0, src)
    summ[:, 3] = status[:, 0]
    return y, summ


# ---------------------------------------------------------------------------
# Tile chaining for streams larger than N_POS
# ---------------------------------------------------------------------------


def split_tokens_tiles(tokens: np.ndarray) -> np.ndarray:
    """Split one stream's tokens (K,) int32 (-1 padding ignored) at N_POS
    output boundaries -> (T, N_POS) int32, -1 padded; tile t covers output
    bytes [t N_POS, (t+1) N_POS). A match straddling a boundary splits in
    two with the same distance (runs are <= 258, so a token spans at most
    two tiles)."""
    toks = tokens[tokens >= 0].astype(np.int64)
    is_m = (toks & TOKEN_MATCH_BIT) != 0
    runs = np.where(is_m, (toks >> 16) & 0x3FF, 1)
    ends = np.cumsum(runs)
    total = int(ends[-1]) if toks.size else 0
    T = max(1, -(-total // N_POS))
    out = np.full((T, N_POS), -1, np.int32)
    if not toks.size:
        return out
    starts = ends - runs
    t0 = starts // N_POS
    straddle = ends > (t0 + 1) * N_POS  # always a match (literals are 1 byte)
    cut = (t0 + 1) * N_POS
    dist_m1 = toks & 0xFFFF
    first = np.where(straddle, TOKEN_MATCH_BIT | ((cut - starts) << 16) | dist_m1, toks)
    # Tile t = [the straddler's second half from tile t-1] ++ [tokens starting in t].
    head = np.zeros(T, np.int64) - 1
    second = (ends[straddle] - cut[straddle]) << 16
    head[t0[straddle] + 1] = TOKEN_MATCH_BIT | second | dist_m1[straddle]
    has_head = head >= 0
    tile_first_idx = np.searchsorted(t0, np.arange(T))
    rank = np.arange(toks.size) - tile_first_idx[t0]
    out[has_head, 0] = head[has_head]
    out[t0, rank + has_head[t0]] = first
    return out


def split_tiles_plain(tokens: torch.Tensor, T: int) -> torch.Tensor:
    """Plain tile split, :func:`split_tiles_device`'s spec and its CPU
    path, in one pass: each token's end (a cumulative sum in int64: a
    stream may pass 2**31 bytes), its start and first tile t0, and its rank
    among the valid tokens of t0 (plus one where the match straddling into
    t0 heads it) give its slot; one scatter places the first parts, another
    the straddlers' second halves at slot 0 of the next tile. Runs are at
    most 1023 < N_POS, so a token spans at most two tiles; a slot past
    N_POS, which only runs of 0 could reach, is dropped as the reference
    drops it.
    """
    L, K = tokens.shape
    dev = tokens.device
    if K == 0:
        return torch.full((L, T, N_POS), -1, dtype=torch.int32, device=dev)
    # Each int64 temporary is freed once it is dead: together they set the
    # split's device memory a token.
    x = tokens.to(torch.int64)
    valid = x >= 0
    is_m = valid & ((x & TOKEN_MATCH_BIT) != 0)
    runs = torch.where(valid, torch.where(is_m, (x >> 16) & 0x3FF, 1), 0)
    ends = runs.cumsum(1)
    starts = ends - runs
    del runs
    t0 = starts // N_POS  # nondecreasing along a lane, -1 entries included
    cut = (t0 + 1) * N_POS
    dist_m1 = x & 0xFFFF
    first = torch.where(is_m, TOKEN_MATCH_BIT | ((torch.minimum(ends, cut) - starts) << 16) | dist_m1, x)
    first = first.to(torch.int32)
    del x, starts
    # The straddler's second half heads tile t0 + 1.
    head_at = torch.where(is_m & (ends > cut) & (t0 + 1 < T), t0 + 1, T)
    heads = torch.full((L, T + 1), -1, dtype=torch.int64, device=dev)
    heads.scatter_(1, head_at, torch.where(head_at < T, TOKEN_MATCH_BIT | ((ends - cut) << 16) | dist_m1, -1))
    del is_m, ends, cut, dist_m1, head_at
    has_head = heads >= 0
    # Valid tokens before each tile's first position (t0 is sorted).
    n_before = valid.cumsum(1) - valid.to(torch.int64)
    tiles = torch.arange(T + 1, device=dev).expand(L, T + 1).contiguous()
    first_pos = torch.searchsorted(t0, tiles)
    tile_base = torch.where(
        first_pos < K, n_before.gather(1, first_pos.clamp(max=K - 1)), valid.sum(1, keepdim=True)
    )
    t = torch.where(valid & (t0 < T), t0, T)
    del t0, valid
    rank = n_before - tile_base.gather(1, t) + has_head.gather(1, t).to(torch.int64)
    del n_before
    keep = (t < T) & (rank < N_POS)
    out = torch.full((L, T * N_POS + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(keep, t * N_POS + rank, T * N_POS), torch.where(keep, first, -1))
    out = out[:, : T * N_POS].view(L, T, N_POS)
    out[:, :, 0] = torch.where(has_head[:, :T], heads[:, :T].to(torch.int32), out[:, :, 0])
    return out


TILE_SPLIT_SEGMENT = 4096  # tokens a block of csrc/tile_split.cu


def split_tiles_device(tokens: torch.Tensor, T: int) -> torch.Tensor:
    """Split (L, K) int32 token streams into N_POS output tiles on their
    device, -1 entries ignored wherever they stand -> (L, T, N_POS) int32,
    -1 padded: tile t holds the second half of the match straddling from
    tile t-1, if any, then the tokens that start in t, in stream order; a
    straddling match keeps its distance with run ``cut - start`` before the
    seam and ``end - cut`` after it. Tokens past tile T-1 are dropped.
    Bit-identical to the reference's ``resolve_pallas.split_tiles_device``
    (which sorts each tile) and to :func:`split_tokens_tiles`.

    On the card one launch of ``csrc/tile_split.cu``: its first blocks
    read the tokens once (segments of TILE_SPLIT_SEGMENT tokens joined by a
    look-back over their byte and token counts) and write every token and
    head to its slot, the later ones write -1 behind each tile's tokens
    once the tile is placed. Its scratch (8 bytes a segment, 16 a tile)
    comes in two halves that calls take in turn, each call zeroing the one
    the call before it used (``_build.alternating_halves``), so a call
    launches nothing else. On the CPU :func:`split_tiles_plain`."""
    _build.require(isinstance(tokens, torch.Tensor) and tokens.dtype == torch.int32 and tokens.dim() == 2,
                   f"tokens: expected a 2-d int32 tensor, got {getattr(tokens, 'dtype', type(tokens))}")
    _build.require(tokens.is_contiguous(), "tokens: must be contiguous")
    L, K = tokens.shape
    _build.require(L >= 1 and T >= 1, f"tokens: shape {tuple(tokens.shape)}, T={T}")
    if not _build.on_card(tokens):
        return split_tiles_plain(tokens, T)
    # The byte prefix saturates at T * N_POS + 1024 and adds up to 2**22 in
    # a segment: both must stay within int32.
    _build.require(T * N_POS + (1 << 23) < 1 << 31, f"T={T}: at most {((1 << 31) - (1 << 23)) // N_POS - 1} tiles")
    _build.require(L <= 65535 and K < (1 << 31) - TILE_SPLIT_SEGMENT, f"tokens: shape {tuple(tokens.shape)}")
    dev = tokens.device
    out = torch.empty((L, T, N_POS), dtype=torch.int32, device=dev)
    scratch, other, dirty = _build.alternating_halves("tile_split", dev,
                                                      L * -(-K // TILE_SPLIT_SEGMENT) + 2 * L * T + 1)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_tile_split(tokens.data_ptr(), out.data_ptr(), scratch.data_ptr(), other.data_ptr(), dirty, L, K,
                                T, _build.stream(dev))
    if err:
        _build.drop_kept_zero("tile_split", dev)
    _build.check(err, "td_tile_split")
    LAUNCHES["tile_split"] += 1
    return out


def resolve_tiles_crc(
    tiles: torch.Tensor, *, tail: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resolve (L, T, N_POS) int32 tile-split token streams and CRC them
    on their device, step by step: step t resolves tile t of every lane
    (expand, sweep) against the previous step's last 32 KiB, writes its
    bytes into one uint8 buffer and runs the lane CRC on them. Step 0
    resolves against ``tail`` (L, 32768) int32, the resolved history before
    the first tile (a later pass over a lane), or against none (None: the
    streams' start). Only one step's int32 bytes live at a time.

    Returns (bytes (L, T N_POS) uint8, summaries (L, T, 8) int32 with the
    sweep's residue in row 3, raw CRC registers (L, T) int64 of each tile's
    bytes)."""
    L, T, N = tiles.shape
    out = torch.empty((L, T * N), dtype=torch.uint8, device=tiles.device)
    summs, raws = [], []
    for t in range(T):
        y, summ = resolve_tokens_device(tiles[:, t].contiguous(), tail=tail)
        y8 = y.to(torch.uint8)
        raws.append(cl.crc32_lanes_raw8(y8))
        out[:, t * N : (t + 1) * N] = y8
        summs.append(summ)
        tail = y[:, N - TAIL :].contiguous()
    return out, torch.stack(summs, 1), torch.stack(raws, 1)


def resolve_tokens_tiled(tiles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve (L, T, N_POS) int32 tile-split token streams on their
    device (:func:`resolve_tiles_crc`: step t resolves tile t of every lane
    with the previous step's last 32 KiB as its tail). Returns (y (L, T,
    N_POS) int32 bytes, summaries (L, T, 8))."""
    y8, summs, _raws = resolve_tiles_crc(tiles)
    return y8.view(tiles.shape).to(torch.int32), summs


def _stream_total(tokens: np.ndarray) -> int:
    toks = np.asarray(tokens, np.int64)
    toks = toks[toks >= 0]
    return int(np.where((toks & TOKEN_MATCH_BIT) != 0, (toks >> 16) & 0x3FF, 1).sum())


def resolve_big_streams(
    token_arrays: list[np.ndarray], device: torch.device
) -> tuple[list[np.ndarray], np.ndarray]:
    """Resolve token streams of any length on ``device``: streams group by
    tile count T, and each group uploads, splits into N_POS tiles on the
    device (:func:`split_tiles_device`) and resolves tile step by tile step
    with chained 32 KiB tails (:func:`resolve_tiles_crc`).

    Returns (per stream the bytes as np.uint8 trimmed to its total output,
    per stream the residue plus the tiles that flagged an error; nonzero
    means the caller must resolve that stream on the host)."""
    totals = [_stream_total(t) for t in token_arrays]
    outs: list = [None] * len(token_arrays)
    resid = np.zeros(len(token_arrays), np.int64)
    bygroup: dict[int, list[int]] = {}
    for i, n in enumerate(totals):
        bygroup.setdefault(max(1, -(-n // N_POS)), []).append(i)
    for T, idxs in sorted(bygroup.items()):
        segs = [torch.from_numpy(np.array(token_arrays[i], np.int32)).to(device) for i in idxs]
        tok = torch.nn.utils.rnn.pad_sequence(segs, batch_first=True, padding_value=-1)
        y8, summs, _raws = resolve_tiles_crc(split_tiles_device(tok, T))
        y8, summs = y8.cpu().numpy(), summs.cpu().numpy()
        for j, i in enumerate(idxs):
            outs[i] = y8[j, : totals[i]]
            resid[i] = int(summs[j, :, 3].sum()) + int((summs[j, :, 0] < N_POS).sum())
    return outs, resid
