"""The port's host encoder against the JAX package's: the bit packers and
the bit reader, the LZ77 match finder and parse, the serial greedy oracle
(the C core's binding against its NumPy plain version, and both against
the reference), every named strategy and efforts 0-5 as raw DEFLATE
(identical bytes, decoded by ``zlib.decompress(raw, -15)``), the streaming
encoder's chunking, history and preset dictionary, and the profile
encoder. Inputs come from seeded NumPy generators; every comparison is
exact. Sizes stay small, since the host encoder is NumPy and Python:
effort 5 on 9000 bytes (one binary split), the oracle on at most 8 KiB,
its NumPy plain version on at most 500 bytes."""

from __future__ import annotations

import gzip
import io
import zlib

import numpy as np
import pytest

import tpu_deflate as ref
from tpu_deflate.codec import deflate_encode as ref_enc
from tpu_deflate.codec import profile as ref_profile
from tpu_deflate.kernels import bitio as ref_bitio
from tpu_deflate.kernels import lz77 as ref_lz77
import tpu_deflate_torch as port
from tpu_deflate_torch.codec import deflate_encode as enc
from tpu_deflate_torch.codec import profile
from tpu_deflate_torch.kernels import bitio, lz77
from tpu_deflate_torch.streams.deflater import Deflater


def text_data(n: int, seed: int) -> bytes:
    """Words with runs, repeats and a stretch of random bytes: every block
    type and match length's input."""
    if n == 0:
        return b""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(150)]
    parts, size = [], 0
    while size < n:
        kind = rng.integers(0, 10)
        if kind < 7:
            p = np.concatenate([words[i] for i in rng.integers(0, 150, 8)])
        elif kind < 8:
            p = np.full(int(rng.integers(3, 400)), rng.integers(0, 256), np.uint8)
        else:
            p = rng.integers(0, 256, int(rng.integers(1, 300)), dtype=np.uint8)
        parts.append(p)
        size += p.size
    return np.concatenate(parts)[:n].tobytes()


def outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "raise", getattr(getattr(e, "reason", None), "name", type(e).__name__)


# --- bits ---------------------------------------------------------------------


@pytest.mark.parametrize("offset", range(8))
def test_pack_bits(offset):
    rng = np.random.default_rng(offset)
    nbits = rng.integers(0, 33, 500)
    values = rng.integers(0, 1 << 32, 500, dtype=np.uint64) & ((np.uint64(1) << nbits.astype(np.uint64))
                                                                  - np.uint64(1))
    got, total = bitio.pack_bits(values, nbits, offset)
    want, want_total = ref_bitio.pack_bits(values, nbits, offset)
    np.testing.assert_array_equal(got, want)
    assert total == want_total == int(nbits.sum()) + offset
    np.testing.assert_array_equal(bitio.unpack_to_bits(got), ref_bitio.unpack_to_bits(want))


def _writer_ops(seed: int) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        k = rng.integers(0, 4)
        if k == 0:
            n = int(rng.integers(0, 58))
            ops.append(("bits", int(rng.integers(0, 1 << min(n, 62))) & ((1 << n) - 1), n))
        elif k == 1:
            nb = rng.integers(0, 20, int(rng.integers(0, 40)))
            vals = rng.integers(0, 1 << 20, nb.size, dtype=np.uint64) & ((np.uint64(1) << nb.astype(np.uint64))
                                                                          - np.uint64(1))
            ops.append(("tokens", vals, nb))
        elif k == 2:
            ops.append(("align",))
        else:
            ops.append(("bytes", rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8).tobytes()))
    return ops


def _drive_writer(w, ops) -> list:
    seen = []
    for op in ops:
        if op[0] == "bits":
            w.write_bits(op[1], op[2])
        elif op[0] == "tokens":
            w.write_token_array(op[1], op[2])
        elif op[0] == "align":
            w.align_to_byte()
        else:
            w.align_to_byte()
            w.write_bytes(op[1])
        seen.append(w.bit_position)
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_bit_writers(seed):
    ops = _writer_ops(seed)
    ours, theirs = bitio.BitWriter(), ref_bitio.BitWriter()
    assert _drive_writer(ours, ops) == _drive_writer(theirs, ops)
    assert ours.getvalue() == theirs.getvalue()
    counting = bitio.CountingBitWriter(start_position=seed)
    assert _drive_writer(counting, ops) == _drive_writer(ref_bitio.CountingBitWriter(start_position=seed), ops)


def _drive_reader(mod, data: bytes, ops: list, buffer_size: int) -> list:
    r = mod.BitReader(io.BytesIO(data), buffer_size=buffer_size)
    seen = []
    for op in ops:
        try:
            if op[0] == "read":
                seen.append(r.read_bits(op[1]))
            elif op[0] == "peek":
                v, avail = r.peek_bits_upto(op[1])
                seen.append((v, avail))
                r.skip_bits(min(avail, op[2]))
            elif op[0] == "align":
                r.align_to_byte()
            else:
                r.align_to_byte()
                seen.append(r.read_aligned_bytes(op[1]))
        except ValueError as e:
            seen.append(("raise", e.reason.name))
            break
        seen.append((r.consumed_bytes, r.bit_position, r.overread_bytes, r.buffered_bits))
    seen.append(r.detach())
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_bit_reader(seed):
    rng = np.random.default_rng(20 + seed)
    data = rng.integers(0, 256, int(rng.integers(0, 600)), dtype=np.uint8).tobytes()
    ops = []
    for _ in range(400):
        k = rng.integers(0, 8)
        if k < 4:
            ops.append(("read", int(rng.integers(0, 33))))
        elif k < 6:
            ops.append(("peek", int(rng.integers(1, 16)), int(rng.integers(0, 16))))
        elif k < 7:
            ops.append(("align",))
        else:
            ops.append(("bytes", int(rng.integers(0, 20))))
    size = int(rng.choice([1, 3, 7, 64, 16384]))
    assert _drive_reader(bitio, data, ops, size) == _drive_reader(ref_bitio, data, ops, size)


# --- LZ77 ---------------------------------------------------------------------

MATCH_PARAMS = [
    dict(min_run=3, max_run=258, min_dist=1, max_dist=32768, max_candidates=16),
    dict(min_run=3, max_run=258, min_dist=1, max_dist=32768, max_candidates=4),
    dict(min_run=3, max_run=258, min_dist=1, max_dist=1, max_candidates=16),  # RLE
    dict(min_run=5, max_run=40, min_dist=3, max_dist=300, max_candidates=8),
    dict(min_run=0, max_run=0, min_dist=0, max_dist=0, max_candidates=16),  # literal only
]


@pytest.mark.parametrize("pi", range(len(MATCH_PARAMS)))
@pytest.mark.parametrize("hist", [0, 3000])
def test_find_best_matches_and_parse(pi, hist):
    kw = MATCH_PARAMS[pi]
    buf = np.frombuffer(text_data(12000, seed=pi + hist), np.uint8)
    run, dist = lz77.find_best_matches(buf, hist, **kw)
    want_run, want_dist = ref_lz77.find_best_matches(buf, hist, **kw)
    np.testing.assert_array_equal(run, want_run)
    np.testing.assert_array_equal(dist, want_dist)
    for lazy in (False, True):
        got = lz77.parse_tokens(run, dist, min_run=kw["min_run"], lazy=lazy)
        want = ref_lz77.parse_tokens(want_run, want_dist, min_run=kw["min_run"], lazy=lazy)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


ORACLE_PARAMS = [
    dict(min_run=3, max_run=258, min_dist=1, max_dist=32768),
    dict(min_run=3, max_run=258, min_dist=1, max_dist=1),
    dict(min_run=4, max_run=30, min_dist=2, max_dist=700),
    dict(min_run=0, max_run=0, min_dist=0, max_dist=0),
]


@pytest.mark.parametrize("pi", range(len(ORACLE_PARAMS)))
def test_exact_greedy_binding_against_plain_and_reference(pi):
    kw = ORACLE_PARAMS[pi]
    for n, hist, seed in ((500, 0, 1), (500, 150, 2), (0, 0, 3), (1, 0, 4)):
        buf = np.frombuffer(text_data(n, seed=seed + 10 * pi), np.uint8)
        got = lz77.exact_greedy_tokens(buf, hist, **kw)
        plain = lz77.exact_greedy_tokens_plain(buf, hist, **kw)
        want = ref_lz77.exact_greedy_tokens(buf, hist, **kw)
        for a, b, c in zip(got, plain, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_exact_greedy_binding_on_longer_input():
    buf = np.frombuffer(text_data(8192, seed=5), np.uint8)
    got = lz77.exact_greedy_tokens(buf, 1024, **ORACLE_PARAMS[0])
    want = ref_lz77.exact_greedy_tokens(buf, 1024, **ORACLE_PARAMS[0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- strategies and efforts ----------------------------------------------------

STRATEGIES = {
    "LITERAL_STATIC": lambda m: m.LITERAL_STATIC,
    "LITERAL_DYNAMIC": lambda m: m.LITERAL_DYNAMIC,
    "RLE_STATIC": lambda m: m.RLE_STATIC,
    "RLE_DYNAMIC": lambda m: m.RLE_DYNAMIC,
    "FULL_STATIC": lambda m: m.FULL_STATIC,
    "FULL_DYNAMIC": lambda m: m.FULL_DYNAMIC,
    "stored": lambda m: m.StoredStrategy(),
    "multi": lambda m: m.MultiStrategy([m.StoredStrategy(), m.FULL_STATIC, m.RLE_DYNAMIC]),
    "binary_split": lambda m: m.BinarySplitStrategy(m.FULL_DYNAMIC, min_block_len=2048),
    "exact": lambda m: m.Lz77HuffmanStrategy(True, exact=True),
    "lazy_deep": lambda m: m.Lz77HuffmanStrategy(False, lazy=True, max_candidates=64),
}


def _check_raw(data: bytes, raw: bytes, want: bytes) -> None:
    assert raw == want
    assert zlib.decompress(raw, -15) == data


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_named_strategies(name):
    data = text_data(4000 if name in ("exact", "lazy_deep", "binary_split") else 10000, seed=len(name))
    raw = port.deflate(data, strategy=STRATEGIES[name](enc), engine="host")
    _check_raw(data, raw, ref.deflate(data, strategy=STRATEGIES[name](ref_enc)))


@pytest.mark.parametrize("effort", range(6))
def test_efforts(effort):
    data = text_data(9000 if effort == 5 else 12000, seed=40 + effort)
    if effort == 5:  # text, then random bytes: the binary split cuts it in two blocks
        data = data[:4600] + np.random.default_rng(5).integers(0, 256, 4400, dtype=np.uint8).tobytes()
    _check_raw(data, port.deflate(data, effort=effort, engine="host"), ref.deflate(data, effort=effort))
    for empty in (b"", b"a"):
        _check_raw(empty, port.deflate(empty, effort=effort, engine="host"), ref.deflate(empty, effort=effort))


def test_effort_out_of_range():
    for e in (-1, 6):
        assert outcome(port.strategy_for_effort, e) == outcome(ref.strategy_for_effort, e) == ("raise",
                                                                                              "ValueError")


@pytest.mark.parametrize("effort", [1, 2])
def test_deflater_chunks_history_and_dictionary(effort):
    """Small lookahead and history (one block per chunk, matches reaching
    back into the previous chunk), a preset dictionary, writes of random
    sizes and single bytes."""
    data = text_data(12000, seed=60 + effort)
    dictionary = text_data(5000, seed=70)
    outs = []
    for mod, strat in ((Deflater, port.strategy_for_effort(effort)),
                       (ref.Deflater, ref.strategy_for_effort(effort))):
        sink = io.BytesIO()
        d = mod(sink, lookahead=4096, history=2048, strategy=strat, preset_dictionary=dictionary)
        cuts = np.sort(np.random.default_rng(effort).integers(0, len(data), 12))
        prev = 0
        for c in list(cuts) + [len(data)]:
            d.write(data[prev:c])
            prev = c
        d.write_byte(7)
        d.finish()
        outs.append((sink.getvalue(), d.bits_written))
    assert outs[0] == outs[1]
    z = zlib.decompressobj(-15, zdict=dictionary[-2048:])
    assert z.decompress(outs[0][0]) == data + b"\x07"


@pytest.mark.parametrize("bad", [dict(lookahead=0), dict(history=-1), dict(history=32769)])
def test_deflater_rejects_capacities(bad):
    assert outcome(Deflater, io.BytesIO(), **bad) == outcome(ref.Deflater, io.BytesIO(), **bad) == (
        "raise", "ValueError")


@pytest.mark.parametrize("case", ["empty", "members", "small_members", "short_codes"])
def test_profile_compress_host(case):
    data = {"empty": b"", "members": text_data(15000, seed=80), "small_members": text_data(9000, seed=81),
            "short_codes": text_data(20000, seed=82)}[case]
    kw = {"small_members": dict(member_data=2048), "short_codes": dict(max_code_len=9, lazy=False,
                                                                        max_candidates=4),
          "members": dict(member_data=6000)}.get(case, {})
    got = profile.profile_compress_host(data, **kw)
    assert got == ref_profile.profile_compress_host(data, **kw)
    assert gzip.decompress(got) == data
    assert profile.build_member(b"xy", 5, 9) == ref_profile.build_member(b"xy", 5, 9)
