"""Per-member and per-stream codec statistics (a copy of
``tpu_deflate.stats``).

``stream_stats`` inspects any gzip stream (the profile's or a foreign one)
and reports member/block structure, ratios, and block-type and symbol
histograms, per block and aggregated. ``StreamStats.as_vector`` is the
fixed-layout int64 vector that ``dist.sharded.psum_stats`` sums over
shards.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from .codec import inflate_host as ih
from .format.gzip_meta import GzipMetadata
from .format.tables import DIST_BASE, DIST_EXTRA, LENGTH_BASE, LENGTH_EXTRA


@dataclass
class BlockStats:
    btype: int  # 0 stored, 1 fixed, 2 dynamic
    compressed_bits: int
    uncompressed_bytes: int
    literals: int = 0
    matches: int = 0
    match_bytes: int = 0
    match_len_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(9, dtype=np.int64)
    )  # log2 buckets of run length 3..258


@dataclass
class StreamStats:
    members: int
    blocks: list[BlockStats]
    compressed_bytes: int
    uncompressed_bytes: int

    @property
    def ratio(self) -> float:
        return self.compressed_bytes / max(1, self.uncompressed_bytes)

    @property
    def block_type_histogram(self) -> dict[str, int]:
        names = {0: "stored", 1: "fixed", 2: "dynamic"}
        out = {"stored": 0, "fixed": 0, "dynamic": 0}
        for b in self.blocks:
            out[names[b.btype]] += 1
        return out

    def as_vector(self) -> np.ndarray:
        """Fixed-layout int64 stat vector for psum aggregation:
        [members, blocks, comp_bytes, uncomp_bytes, stored, fixed, dynamic,
         literals, matches, match_bytes, mlh0..mlh8]."""
        h = self.block_type_histogram
        mlh = np.zeros(9, dtype=np.int64)
        lits = matches = mbytes = 0
        for b in self.blocks:
            mlh += b.match_len_hist
            lits += b.literals
            matches += b.matches
            mbytes += b.match_bytes
        return np.concatenate(
            [
                np.array(
                    [
                        self.members,
                        len(self.blocks),
                        self.compressed_bytes,
                        self.uncompressed_bytes,
                        h["stored"],
                        h["fixed"],
                        h["dynamic"],
                        lits,
                        matches,
                        mbytes,
                    ],
                    dtype=np.int64,
                ),
                mlh,
            ]
        )


class _StatsInflater:
    """Minimal symbol-level walker that only collects statistics."""

    def __init__(self, source):
        self._core = ih.Inflater(source)

    def walk(self) -> list[BlockStats]:
        # Reuse the host decoder but intercept at block level by decoding
        # fully and tracking via its internals would be invasive; instead
        # re-implement the tiny walk with the same building blocks.
        core = self._core
        r = core._reader
        blocks: list[BlockStats] = []
        last = False
        while not last:
            start_bits = r.bit_position
            last = r.read_bits(1) == 1
            btype = r.read_bits(2)
            bs = BlockStats(btype=btype, compressed_bits=0, uncompressed_bytes=0)
            if btype == 0:
                core._begin_stored()
                n = core._stored_remaining
                if n:
                    core._stored_step(n)
                bs.uncompressed_bytes = n
                bs.literals = n
                core._pending.clear()
            elif btype in (1, 2):
                if btype == 1:
                    core._litlen_lut = ih._FIXED_LITLEN_LUT
                    core._dist_lut = ih._FIXED_DIST_LUT
                else:
                    core._litlen_lut, core._dist_lut = core._parse_dynamic_header()
                produced0 = len(core._pending)
                core._state = ih._S_HUFFMAN
                # decode the whole block, counting symbols
                lits = matches = mbytes = 0
                mlh = np.zeros(9, dtype=np.int64)
                while True:
                    sym = core._decode_symbol(core._litlen_lut)
                    if sym == 256:
                        break
                    if sym < 256:
                        core._pending.append(sym)
                        core._window[core._window_pos] = sym
                        core._window_pos = (core._window_pos + 1) % ih.WINDOW_SIZE
                        core._window_len = min(ih.WINDOW_SIZE, core._window_len + 1)
                        lits += 1
                        continue
                    run = int(LENGTH_BASE[sym - 257]) + r.read_bits(int(LENGTH_EXTRA[sym - 257]))
                    dsym = core._decode_symbol(core._dist_lut)
                    dist = int(DIST_BASE[dsym]) + r.read_bits(int(DIST_EXTRA[dsym]))
                    core._copy_match(run, dist)
                    matches += 1
                    mbytes += run
                    mlh[min(8, max(0, int(np.log2(max(run - 2, 1))))) ] += 1
                bs.uncompressed_bytes = len(core._pending) - produced0
                bs.literals = lits
                bs.matches = matches
                bs.match_bytes = mbytes
                bs.match_len_hist = mlh
                core._pending.clear()
            end_bits = r.bit_position
            bs.compressed_bits = end_bits - start_bits
            blocks.append(bs)
        return blocks


def stream_stats(gz: bytes) -> StreamStats:
    """Analyze a gzip stream's structure (decodes it once, host-side)."""
    stream = io.BytesIO(gz)
    blocks: list[BlockStats] = []
    members = 0
    total_out = 0
    while True:
        pos = stream.tell()
        if not stream.read(1):
            break
        stream.seek(pos)
        GzipMetadata.read(stream)
        walker = _StatsInflater(stream)
        mblocks = walker.walk()
        blocks.extend(mblocks)
        total_out += sum(b.uncompressed_bytes for b in mblocks)
        members += 1
        # reposition after payload + trailer
        tail = walker._core._reader.detach()
        rest = tail + stream.read()
        stream = io.BytesIO(rest[8:])  # skip trailer
    return StreamStats(
        members=members,
        blocks=blocks,
        compressed_bytes=len(gz),
        uncompressed_bytes=total_out,
    )
