"""The data set and the decode inputs: the generator is deterministic per
seed, its parts keep their proportions and kinds, and the layouts' streams
(the frozen C core's members, zlib's level-9 member), read by the reference
(and by Python's gzip module), give the data set back. The reference's
block check holds members to the profile."""

from __future__ import annotations

import gzip
import json
import os
import zlib

import numpy as np
import pytest
from conftest import BENCH

import harness
import refcheck
from gen import core, corpus

with open(os.path.join(BENCH, "configs", "td_profile64k.json")) as f:
    PARTS = json.load(f)["corpus"]["parts"]
with open(os.path.join(BENCH, "configs", "archive_w32k.json")) as f:
    ARCHIVE_LAYOUT = json.load(f)["layout"]
BIG_SEED = 2**33 + 12345  # past 32 bits, as the driver's seeds are


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = corpus.make(1 << 20, PARTS, BIG_SEED)
    assert np.array_equal(a, corpus.make(1 << 20, PARTS, BIG_SEED))
    assert not np.array_equal(a, corpus.make(1 << 20, PARTS, BIG_SEED + 1))


@pytest.mark.parametrize("total", [211_938_580, 1 << 20, 1_000_003])
def test_part_sizes_follow_the_shares(total):
    sizes = corpus.part_sizes(total, PARTS)
    assert sum(sizes) == total
    for size, p in zip(sizes, PARTS):
        assert abs(size - total * p["share"]) < len(PARTS)  # rounding, gathered in the last part


def test_parts_hold_their_kinds():
    total = 1 << 21
    data = corpus.make(total, PARTS, BIG_SEED)
    at = np.cumsum([0, *corpus.part_sizes(total, PARTS)])
    text, records, runs, rand = (data[at[i] : at[i + 1]] for i in range(4))
    assert text.min() >= ord("a") and text.max() <= ord("z")
    rec = PARTS[1]["record_bytes"]
    same = np.mean(records[rec:] == records[:-rec])  # a byte equals the record's byte unless either is noise
    assert abs(same - (1 - PARTS[1]["noise"]) ** 2) < 0.01
    assert runs.max() < PARTS[2]["values"]
    assert abs(np.count_nonzero(np.diff(runs)) / runs.size - 1.5 / PARTS[2]["max_run"]) < 1e-3
    assert abs(rand.mean() - 127.5) < 1.0


def test_seeds_change_the_content_not_the_work():
    """Every seed gives the same word lengths, so the streams' sizes (the
    decode's tokens, the encode's ratio) agree across seeds to within a
    fraction of a percent; with lengths from the seed they moved by a fifth."""
    sizes = [len(core.members(corpus.make(4 << 20, PARTS, BIG_SEED + 7919 * k), member_bytes=65536,
                              max_code_len=12, max_chain=32)) for k in range(4)]
    assert max(sizes) / min(sizes) < 1.005


def test_word_ids_follow_zipf_modulo_the_vocabulary():
    q = corpus.zipf_mod(1.3, 200)
    draws = np.bincount(np.random.default_rng(1).zipf(1.3, 1_000_000) % 200, minlength=200) / 1e6
    assert np.abs(q - draws).max() < 0.003


def test_member_stream_reads_back_to_the_data():
    data = corpus.make(3 << 20, PARTS, BIG_SEED)
    stream = core.members(data, member_bytes=65536, max_code_len=12, max_chain=32)
    r = refcheck.read_stream(stream)
    assert r.out == data.tobytes() and r.members == 48
    assert r.bad_td == r.bad_trailer == r.bad_header == r.bad_payload == 0
    assert all(s == 65536 for s in r.isizes)
    assert gzip.decompress(stream) == data.tobytes()
    stored = sum((stream[m + 20] >> 1) & 3 == 0 for m in _member_starts(stream))
    assert 0 < stored < 48  # the random part is stored, the rest is not


def test_archive_member_reads_back_to_the_data():
    """The archive's read-back member: one gzip member of zlib level 9's
    deflate stream, byte for byte what zlib writes, in several blocks."""
    data = corpus.make(1 << 20, PARTS, BIG_SEED)
    member = harness.load_part("layouts", ARCHIVE_LAYOUT["kind"]).write(data, ARCHIVE_LAYOUT)
    r = refcheck.read_stream(member)
    assert r.out == data.tobytes() and r.members == 1
    assert r.bad_td == r.bad_trailer == r.bad_header == r.bad_payload == 0
    assert gzip.decompress(member) == data.tobytes()
    z = zlib.compressobj(9, zlib.DEFLATED, -15)
    assert member[20:-8] == z.compress(data.tobytes()) + z.flush()
    assert refcheck.block_fault(member[20:-8], 15) == 1  # more than one block


def test_block_check_passes_the_profile_and_refuses_what_departs():
    data = corpus.make(1 << 20, PARTS, BIG_SEED)
    stream = core.members(data, member_bytes=65536, max_code_len=12, max_chain=32)
    r = refcheck.read_stream(stream)
    faults = [refcheck.block_fault(stream[s:e], 12) for s, e in r.payloads]
    assert faults == [0] * 16
    stored = [stream[s] >> 1 & 3 == 0 for s, _e in r.payloads]
    assert any(stored) and not all(stored)
    # Codes capped at 9 bits: the text's members (the first half) depart, no stored one does.
    at9 = [refcheck.block_fault(stream[s:e], 9) for s, e in r.payloads]
    assert all(at9[:8]) and not any(f for f, x in zip(at9, stored) if x)
    raw = data[: 1 << 16].tobytes()
    z = zlib.compressobj(6, zlib.DEFLATED, -15)
    two = z.compress(raw[:30000]) + z.flush(zlib.Z_FULL_FLUSH) + z.compress(raw[30000:]) + z.flush()
    assert refcheck.block_fault(two, 15) == 1  # a non-final block first
    fixed = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    one = fixed.compress(raw) + fixed.flush()
    assert refcheck.block_fault(one, 12) == 0 and refcheck.block_fault(one, 8) == 1
    assert refcheck.block_fault(b"\x07", 15) == 1  # reserved block type
    assert refcheck.block_fault(b"\x05", 15) == 1  # a dynamic header cut short


def test_td_spans_follow_the_sizes():
    data = corpus.make(1 << 20, PARTS, BIG_SEED)
    stream = core.members(data, member_bytes=65536, max_code_len=12, max_chain=32)
    spans = refcheck.td_spans(stream)
    assert [s for s, _e in spans] == _member_starts(stream) and spans[-1][1] == len(stream)


def _member_starts(stream: bytes) -> list:
    pos, out = 0, []
    while pos < len(stream):
        out.append(pos)
        pos += int.from_bytes(stream[pos + 16 : pos + 20], "little")
    return out
