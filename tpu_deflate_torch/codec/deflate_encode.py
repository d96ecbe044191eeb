"""Raw-DEFLATE host encoder: vectorized tokenization and the strategy/plan
system (a copy of ``tpu_deflate.codec.deflate_encode``).

- A **Strategy** plans the encoding of one chunk ``(buf, history_len)`` and
  returns a **BlockPlan** that reports its cost in bits for each of the 8
  possible starting bit alignments and can serialize itself.
- ``Lz77HuffmanStrategy`` is parameterized ``(dynamic, min_run, max_run,
  min_dist, max_dist)`` like the reference library's record, with the same
  six presets (``LITERAL_*``, ``RLE_*``, ``FULL_*``).
- Plans compute their exact bit cost analytically from histograms, and
  emission is a single vectorized scatter of (value, nbits) token slots.
- ``MultiStrategy`` keeps the cheapest sub-plan per start alignment;
  ``BinarySplitStrategy`` splits a chunk in halves while that lowers the
  total, which makes multi-block streams.

Encoder-side degenerate-histogram fixes mirror the reference: empty chunk
-> dummy literal-0 count; single used distance -> bump an adjacent
distance count; no distances -> hdist=0 with a single zero length.
``_clen_rle`` (the code-length-code RLE) is shared with the device
encoder's header planning (``codec/encode_np.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..format.tables import (
    CLEN_ORDER,
    DIST_TO_EXTRA_BITS,
    DIST_TO_EXTRA_VAL,
    DIST_TO_SYMBOL,
    EOB_SYMBOL,
    FIXED_DIST_LENGTHS,
    FIXED_LITLEN_LENGTHS,
    LENGTH_TO_EXTRA_BITS,
    LENGTH_TO_EXTRA_VAL,
    LENGTH_TO_SYMBOL,
    MAX_DIST,
    MAX_RUN,
    MIN_DIST,
    MIN_RUN,
)
from ..kernels import lz77
from ..kernels.huffman import canonical_codes, package_merge_lengths

MAX_STORED_BLOCK = (1 << 16) - 1


# ---------------------------------------------------------------------------
# Plans (≙ Decision)
# ---------------------------------------------------------------------------


class BlockPlan:
    """A committed encoding plan for one chunk of data.

    ``bit_lengths[i]`` is the exact serialized size in bits when emission
    starts at bit alignment i (mod 8); ``emit(writer, is_final)`` serializes
    (the writer's current alignment selects alignment-dependent behavior).
    """

    bit_lengths: np.ndarray  # int64[8]

    def emit(self, writer, is_final: bool) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class StoredPlan(BlockPlan):
    """Stored (btype=00) blocks, split at the 65,535-byte format limit.

    Cost/emission semantics of ``comp/Uncompressed.java:19-48`` including
    the alignment-dependent padding and the empty-chunk single block.
    """

    def __init__(self, data: np.ndarray):
        self._data = data
        n = data.size
        num_blocks = max(-(-n // MAX_STORED_BLOCK), 1)
        self.bit_lengths = np.array(
            [n * 8 + num_blocks * 40 + ((13 - i) % 8 - 5) for i in range(8)],
            dtype=np.int64,
        )

    def emit(self, writer, is_final: bool) -> None:
        data = self._data
        index, end = 0, data.size
        while True:
            n = min(end - index, MAX_STORED_BLOCK)
            writer.write_bits(1 if (is_final and n == end - index) else 0, 1)
            writer.write_bits(0, 2)
            writer.align_to_byte()
            writer.write_bits(n, 16)
            writer.write_bits(n ^ 0xFFFF, 16)
            writer.write_bytes(data[index : index + n].tobytes())
            index += n
            if index >= end:
                break


@dataclass
class _TokenStream:
    """Tokenized chunk: parallel arrays, one entry per token."""

    litlen_sym: np.ndarray  # int32: literal byte, length symbol, or 256
    len_extra_val: np.ndarray
    len_extra_bits: np.ndarray
    dist_sym: np.ndarray  # -1 for literals
    dist_extra_val: np.ndarray
    dist_extra_bits: np.ndarray


def _tokenize(
    buf: np.ndarray,
    history_len: int,
    *,
    min_run: int,
    max_run: int,
    min_dist: int,
    max_dist: int,
    lazy: bool = False,
    max_candidates: int = 16,
    exact: bool = False,
) -> _TokenStream:
    """LZ77-tokenize buf[history_len:] (window may reach into history)."""
    data = buf[history_len:]
    m = data.size
    if min_run == 0 or m == 0:
        run = np.zeros(m, np.int32)
        dist = np.zeros(m, np.int32)
        tok_pos = np.arange(m, dtype=np.int64)
        tok_run = run
        tok_dist = dist
    elif exact:
        tok_pos, tok_run, tok_dist = lz77.exact_greedy_tokens(
            buf,
            history_len,
            min_run=min_run,
            max_run=max_run,
            min_dist=min_dist,
            max_dist=max_dist,
        )
    else:
        run, dist = lz77.find_best_matches(
            buf,
            history_len,
            min_run=min_run,
            max_run=max_run,
            min_dist=min_dist,
            max_dist=max_dist,
            max_candidates=max_candidates,
        )
        tok_pos, tok_run, tok_dist = lz77.parse_tokens(
            run, dist, min_run=min_run, lazy=lazy
        )

    is_match = tok_run > 0
    lit_vals = data[tok_pos].astype(np.int32)
    litlen_sym = np.where(is_match, LENGTH_TO_SYMBOL[np.minimum(tok_run, MAX_RUN)], lit_vals)
    len_eb = np.where(is_match, LENGTH_TO_EXTRA_BITS[np.minimum(tok_run, MAX_RUN)], 0)
    len_ev = np.where(is_match, LENGTH_TO_EXTRA_VAL[np.minimum(tok_run, MAX_RUN)], 0)
    dist_idx = np.where(is_match, tok_dist, 1)
    dist_sym = np.where(is_match, DIST_TO_SYMBOL[dist_idx], -1)
    dist_eb = np.where(is_match, DIST_TO_EXTRA_BITS[dist_idx], 0)
    dist_ev = np.where(is_match, DIST_TO_EXTRA_VAL[dist_idx], 0)

    # Append the end-of-block symbol.
    litlen_sym = np.concatenate([litlen_sym, [EOB_SYMBOL]]).astype(np.int32)
    len_ev = np.concatenate([len_ev, [0]]).astype(np.int32)
    len_eb = np.concatenate([len_eb, [0]]).astype(np.int32)
    dist_sym = np.concatenate([dist_sym, [-1]]).astype(np.int32)
    dist_ev = np.concatenate([dist_ev, [0]]).astype(np.int32)
    dist_eb = np.concatenate([dist_eb, [0]]).astype(np.int32)
    return _TokenStream(litlen_sym, len_ev, len_eb, dist_sym, dist_ev, dist_eb)


def _clen_rle(code_lens: np.ndarray) -> tuple[list[int], list[int]]:
    """Greedy RFC 1951 code-length-code run-length encoding.

    Same greedy rules as ``comp/Lz77Huffman.java:189-223``: zero runs of
    3-10 -> 17, 11-138 -> 18; repeat-previous runs of 3-6 -> 16; otherwise
    literal lengths.
    """
    symbols: list[int] = []
    extras: list[int] = []
    i = 0
    n = code_lens.size
    while i < n:
        val = int(code_lens[i])
        if val == 0:
            run = 1
            while run < 138 and i + run < n and code_lens[i + run] == 0:
                run += 1
            if run < 3:
                symbols.append(0)
                i += 1
            elif run < 11:
                symbols.append(17)
                extras.append(run - 3)
                i += run
            else:
                symbols.append(18)
                extras.append(run - 11)
                i += run
            continue
        if i > 0:
            run = 0
            while run < 6 and i + run < n and code_lens[i + run] == code_lens[i - 1]:
                run += 1
            if run >= 3:
                symbols.append(16)
                extras.append(run - 3)
                i += run
                continue
        symbols.append(val)
        i += 1
    return symbols, extras


_CLEN_EXTRA_BITS = {16: 2, 17: 3, 18: 7}


@dataclass
class _DynamicHeader:
    """Planned dynamic-block header: code lengths + serialized layout."""

    litlen_lengths: np.ndarray  # trimmed (>=257 entries)
    dist_lengths: np.ndarray  # trimmed (>=1 entries; [0] if no distances)
    clen_symbols: list[int]
    clen_extras: list[int]
    clen_lengths: np.ndarray  # 19 entries
    num_clen: int  # hclen + 4

    @property
    def header_bits(self) -> int:
        bits = 5 + 5 + 4 + 3 * self.num_clen
        for s in self.clen_symbols:
            bits += int(self.clen_lengths[s]) + _CLEN_EXTRA_BITS.get(s, 0)
        return bits


def _plan_dynamic_codes(
    litlen_hist: np.ndarray, dist_hist: np.ndarray, max_code_len: int = 15
) -> tuple[np.ndarray, np.ndarray, _DynamicHeader]:
    """Build dynamic litlen/dist code lengths + header plan from histograms.

    Returns (full litlen lengths[288], full dist lengths[30 padded to 32],
    header). Mirrors the reference's degenerate fixes.
    """
    litlen_hist = litlen_hist.astype(np.int64).copy()
    dist_hist = dist_hist.astype(np.int64).copy()

    if litlen_hist.sum() == litlen_hist[EOB_SYMBOL]:
        # Block with no symbols besides EOB (empty data): dummy literal 0.
        litlen_hist[0] += 1
    # Trim trailing unused litlen symbols (but keep at least 257).
    hi = litlen_hist.size
    while hi > 257 and litlen_hist[hi - 1] == 0:
        hi -= 1
    litlen_trim = litlen_hist[:hi]
    litlen_lengths_trim = package_merge_lengths(litlen_trim, max_code_len)

    used_dist = int((dist_hist > 0).sum())
    if used_dist == 1:
        i = int(np.nonzero(dist_hist)[0][0])
        if i + 1 < dist_hist.size:
            dist_hist[i + 1] = 1
        else:
            dist_hist[i - 1] = 1
    hi_d = dist_hist.size
    while hi_d > 1 and dist_hist[hi_d - 1] == 0:
        hi_d -= 1
    dist_trim = dist_hist[:hi_d]
    if dist_trim.size == 1 and dist_trim[0] == 0:
        dist_lengths_trim = np.zeros(1, dtype=np.int32)
    else:
        dist_lengths_trim = package_merge_lengths(dist_trim, max_code_len)

    code_lens = np.concatenate([litlen_lengths_trim, dist_lengths_trim])
    clen_symbols, clen_extras = _clen_rle(code_lens)
    clen_hist = np.bincount(np.array(clen_symbols, dtype=np.int64), minlength=19)
    if int((clen_hist > 0).sum()) < 2:
        # Guard: a single used clen symbol cannot form a complete code;
        # give a 1-bit code to a harmless neighbor (costs 3 header bits).
        i = int(np.nonzero(clen_hist)[0][0]) if clen_hist.any() else 0
        clen_hist[(i + 1) % 19] += 1
    clen_lengths = package_merge_lengths(clen_hist, 7)
    reordered = clen_lengths[CLEN_ORDER]
    num_clen = 19
    while num_clen > 4 and reordered[num_clen - 1] == 0:
        num_clen -= 1

    header = _DynamicHeader(
        litlen_lengths=litlen_lengths_trim,
        dist_lengths=dist_lengths_trim,
        clen_symbols=clen_symbols,
        clen_extras=clen_extras,
        clen_lengths=clen_lengths,
        num_clen=num_clen,
    )
    full_litlen = np.zeros(288, dtype=np.int32)
    full_litlen[: litlen_lengths_trim.size] = litlen_lengths_trim
    full_dist = np.zeros(32, dtype=np.int32)
    full_dist[: dist_lengths_trim.size] = dist_lengths_trim
    return full_litlen, full_dist, header


class HuffmanPlan(BlockPlan):
    """A fixed- or dynamic-Huffman compressed block plan for one chunk."""

    def __init__(self, tokens: _TokenStream, dynamic: bool, max_code_len: int = 15):
        self._tokens = tokens
        self._dynamic = dynamic

        litlen_hist = np.bincount(tokens.litlen_sym, minlength=288).astype(np.int64)
        match_mask = tokens.dist_sym >= 0
        dist_hist = np.bincount(
            tokens.dist_sym[match_mask], minlength=30
        ).astype(np.int64) if match_mask.any() else np.zeros(30, dtype=np.int64)

        if dynamic:
            self._litlen_lengths, self._dist_lengths, self._header = _plan_dynamic_codes(
                litlen_hist, dist_hist, max_code_len
            )
            header_bits = self._header.header_bits
        else:
            self._litlen_lengths = FIXED_LITLEN_LENGTHS
            self._dist_lengths = FIXED_DIST_LENGTHS
            self._header = None
            header_bits = 0

        body_bits = int((litlen_hist * self._litlen_lengths).sum())
        body_bits += int(tokens.len_extra_bits.sum())
        body_bits += int((dist_hist * self._dist_lengths[:30]).sum())
        body_bits += int(tokens.dist_extra_bits.sum())
        total = 3 + header_bits + body_bits
        self.bit_lengths = np.full(8, total, dtype=np.int64)

    def emit(self, writer, is_final: bool) -> None:
        writer.write_bits(1 if is_final else 0, 1)
        writer.write_bits(2 if self._dynamic else 1, 2)

        litlen_codes = canonical_codes(self._litlen_lengths, validate=False)
        dist_codes = canonical_codes(self._dist_lengths, validate=False)

        if self._dynamic:
            h = self._header
            writer.write_bits(h.litlen_lengths.size - 257, 5)
            writer.write_bits(h.dist_lengths.size - 1, 5)
            writer.write_bits(h.num_clen - 4, 4)
            reordered = h.clen_lengths[CLEN_ORDER]
            for i in range(h.num_clen):
                writer.write_bits(int(reordered[i]), 3)
            clen_codes = canonical_codes(h.clen_lengths, validate=False)
            extra_iter = iter(h.clen_extras)
            for sym in h.clen_symbols:
                writer.write_bits(int(clen_codes[sym]), int(h.clen_lengths[sym]))
                if sym >= 16:
                    writer.write_bits(next(extra_iter), _CLEN_EXTRA_BITS[sym])

        # Vectorized body emission: each token occupies 4 (value, nbits)
        # slots — litlen code, length extra, dist code, dist extra — with
        # nbits=0 slots contributing nothing.
        t = self._tokens
        n = t.litlen_sym.size
        values = np.zeros((n, 4), dtype=np.uint64)
        nbits = np.zeros((n, 4), dtype=np.int64)
        values[:, 0] = litlen_codes[t.litlen_sym]
        nbits[:, 0] = self._litlen_lengths[t.litlen_sym]
        values[:, 1] = t.len_extra_val
        nbits[:, 1] = t.len_extra_bits
        is_match = t.dist_sym >= 0
        dist_sym = np.where(is_match, t.dist_sym, 0)
        values[:, 2] = np.where(is_match, dist_codes[dist_sym], 0)
        nbits[:, 2] = np.where(is_match, self._dist_lengths[dist_sym], 0)
        values[:, 3] = t.dist_extra_val
        nbits[:, 3] = t.dist_extra_bits
        writer.write_token_array(values.ravel(), nbits.ravel())


class CompositePlan(BlockPlan):
    """Alignment-dispatched composition of sub-plans (Multi/BinarySplit)."""

    def __init__(self, bit_lengths: np.ndarray, plans_per_alignment: list[list[BlockPlan]]):
        self.bit_lengths = bit_lengths
        self._plans = plans_per_alignment

    def emit(self, writer, is_final: bool) -> None:
        plans = self._plans[writer.bit_position % 8]
        for i, p in enumerate(plans):
            p.emit(writer, is_final and i == len(plans) - 1)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


class Strategy:
    """Plans how to encode one chunk (≙ ``comp/Strategy.java``)."""

    def plan(self, buf: np.ndarray, history_len: int) -> BlockPlan:
        raise NotImplementedError


class StoredStrategy(Strategy):
    def plan(self, buf: np.ndarray, history_len: int) -> BlockPlan:
        return StoredPlan(buf[history_len:])


@dataclass(frozen=True)
class Lz77HuffmanStrategy(Strategy):
    """(dynamic, min_run, max_run, min_dist, max_dist) — reference-preset
    compatible. min_run=0 disables matching (literal-only)."""

    dynamic: bool = True
    min_run: int = MIN_RUN
    max_run: int = MAX_RUN
    min_dist: int = MIN_DIST
    max_dist: int = MAX_DIST
    lazy: bool = False
    max_candidates: int = 16
    # exact=True reproduces the reference's serial greedy matcher verbatim
    # (exhaustive distance scan, smallest-distance tie-break) — the
    # ratio-measurement oracle, O(n * max_dist).
    exact: bool = False

    def plan(self, buf: np.ndarray, history_len: int) -> BlockPlan:
        tokens = _tokenize(
            buf,
            history_len,
            min_run=self.min_run,
            max_run=self.max_run,
            min_dist=self.min_dist,
            max_dist=self.max_dist,
            lazy=self.lazy,
            max_candidates=self.max_candidates,
            exact=self.exact,
        )
        return HuffmanPlan(tokens, self.dynamic)


LITERAL_STATIC = Lz77HuffmanStrategy(False, 0, 0, 0, 0)
LITERAL_DYNAMIC = Lz77HuffmanStrategy(True, 0, 0, 0, 0)
RLE_STATIC = Lz77HuffmanStrategy(False, MIN_RUN, MAX_RUN, 1, 1)
RLE_DYNAMIC = Lz77HuffmanStrategy(True, MIN_RUN, MAX_RUN, 1, 1)
FULL_STATIC = Lz77HuffmanStrategy(False, MIN_RUN, MAX_RUN, MIN_DIST, MAX_DIST)
FULL_DYNAMIC = Lz77HuffmanStrategy(True, MIN_RUN, MAX_RUN, MIN_DIST, MAX_DIST)


@dataclass
class MultiStrategy(Strategy):
    """Run every sub-strategy; keep the cheapest per start alignment
    (``comp/MultiStrategy.java:31-56`` semantics)."""

    strategies: list[Strategy]

    def __post_init__(self):
        if not self.strategies:
            raise ValueError("Empty list of strategies")

    def plan(self, buf: np.ndarray, history_len: int) -> BlockPlan:
        best_bits = np.full(8, np.iinfo(np.int64).max, dtype=np.int64)
        best_plan: list[BlockPlan | None] = [None] * 8
        for st in self.strategies:
            p = st.plan(buf, history_len)
            for i in range(8):
                if p.bit_lengths[i] < best_bits[i]:
                    best_bits[i] = p.bit_lengths[i]
                    best_plan[i] = p
        return CompositePlan(best_bits, [[p] for p in best_plan])


@dataclass
class BinarySplitStrategy(Strategy):
    """Recursively split the chunk in half when that lowers total bits,
    with alignment-aware cost chaining (``comp/BinarySplit.java:30-80``)."""

    substrategy: Strategy
    min_block_len: int = 1024

    def plan(self, buf: np.ndarray, history_len: int) -> BlockPlan:
        return self._plan(buf, history_len, self.substrategy.plan(buf, history_len))

    def _plan(self, buf: np.ndarray, history_len: int, cur: BlockPlan) -> BlockPlan:
        data_len = buf.size - history_len
        bit_lengths = cur.bit_lengths.copy()
        plans_per_alignment: list[list[BlockPlan]] = [[cur] for _ in range(8)]

        first_half = (data_len + 1) // 2
        second_half = data_len - first_half
        if min(first_half, second_half) > self.min_block_len:
            left_buf = buf[: history_len + first_half]
            left = self.substrategy.plan(left_buf, history_len)
            right = self.substrategy.plan(buf, history_len + first_half)

            def chained(l: BlockPlan, r: BlockPlan, start: int) -> int:
                bits = 0
                for dec in (l, r):
                    bits += int(dec.bit_lengths[(start + bits) % 8])
                return bits

            improved = any(
                chained(left, right, i) < int(bit_lengths[i]) for i in range(8)
            )
            if improved:
                left = self._plan(left_buf, history_len, left)
                right = self._plan(buf, history_len + first_half, right)
            for i in range(8):
                bits = chained(left, right, i)
                if bits < bit_lengths[i]:
                    bit_lengths[i] = bits
                    plans_per_alignment[i] = [left, right]
        return CompositePlan(bit_lengths, plans_per_alignment)
