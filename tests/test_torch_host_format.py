"""The port's host format layer against the JAX package's: the RFC 1951
tables, the zlib and gzip header records (read, to_bytes and every
rejected header, with the same Reason), the host checksums (Adler-32 and
both combines, also against Python's zlib) and the canonical Huffman
helpers (package-merge lengths, canonical codes, decode LUTs and code
validation). Inputs come from seeded NumPy generators; every comparison is
exact."""

from __future__ import annotations

import io
import zlib

import numpy as np
import pytest

from tpu_deflate.format import gzip_meta as ref_gzip
from tpu_deflate.format import tables as ref_tables
from tpu_deflate.format import zlib_meta as ref_zlib
from tpu_deflate.kernels import checksum as ref_ck
from tpu_deflate.kernels import huffman as ref_huff
from tpu_deflate_torch.format import gzip_meta, tables, zlib_meta
from tpu_deflate_torch.format.errors import DataFormatError
from tpu_deflate_torch.kernels import checksum, huffman

TABLE_NAMES = [
    "MIN_RUN", "MAX_RUN", "MIN_DIST", "MAX_DIST", "WINDOW_SIZE", "NUM_LITLEN_SYMS", "NUM_DIST_SYMS",
    "NUM_CLEN_SYMS", "EOB_SYMBOL", "MAX_CODE_LEN", "MAX_CLEN_CODE_LEN", "CLEN_ORDER", "LENGTH_BASE",
    "LENGTH_EXTRA", "DIST_BASE", "DIST_EXTRA", "LENGTH_TO_SYMBOL", "LENGTH_TO_EXTRA_BITS",
    "LENGTH_TO_EXTRA_VAL", "DIST_TO_SYMBOL", "DIST_TO_EXTRA_BITS", "DIST_TO_EXTRA_VAL",
    "FIXED_LITLEN_LENGTHS", "FIXED_DIST_LENGTHS",
]


def outcome(fn, *args, **kw):
    """("ok", value) or the error's kind: ("reason", name) for a
    DataFormatError of either package, else ("raise", exception type)."""
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        reason = getattr(e, "reason", None)
        if reason is not None:
            return "reason", reason.name
        return "raise", type(e).__name__
    except TypeError as e:
        return "raise", type(e).__name__


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_tables_match_reference(name):
    ours, theirs = getattr(tables, name), getattr(ref_tables, name)
    assert type(ours) is type(theirs)
    if isinstance(ours, np.ndarray):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert ours == theirs


# --- zlib headers -------------------------------------------------------------


def _zlib_fields(meta) -> tuple:
    return (meta.compression_method.name, meta.compression_info, meta.preset_dictionary,
            meta.compression_level.name)


def _zlib_read(mod, data: bytes):
    src = io.BytesIO(data)
    got = outcome(mod.ZlibMetadata.read, src)
    if got[0] == "ok":
        return "ok", _zlib_fields(got[1]), src.tell()
    return got


_ZLIB_RECORDS = [
    {},
    {"compression_level": "FASTEST"},
    {"compression_level": "MAXIMUM", "compression_info": 0},
    {"preset_dictionary": 0x12345678},
    {"preset_dictionary": 0, "compression_level": "FAST", "compression_info": 3},
    {"compression_method": "RESERVED", "compression_info": 15},
]


@pytest.mark.parametrize("fields", _ZLIB_RECORDS, ids=[str(i) for i in range(len(_ZLIB_RECORDS))])
def test_zlib_metadata_write_and_read(fields):
    def make(mod):
        kw = dict(fields)
        if "compression_level" in kw:
            kw["compression_level"] = mod.CompressionLevel[kw["compression_level"]]
        if "compression_method" in kw:
            kw["compression_method"] = mod.CompressionMethod[kw["compression_method"]]
        return mod.ZlibMetadata(**kw)

    ours, theirs = make(zlib_meta), make(ref_zlib)
    wire = ours.to_bytes()
    assert wire == theirs.to_bytes()
    sink = io.BytesIO()
    ours.write(sink)
    assert sink.getvalue() == wire
    assert _zlib_read(zlib_meta, wire + b"rest") == _zlib_read(ref_zlib, wire + b"rest")
    assert _zlib_fields(zlib_meta.ZlibMetadata.read(io.BytesIO(wire))) == _zlib_fields(ours)


def test_zlib_metadata_rejects_like_reference():
    rng = np.random.default_rng(50)
    pairs = {(c, f) for c in range(256) for f in range(0, 256, 7)}
    pairs |= {tuple(int(x) for x in rng.integers(0, 256, 2)) for _ in range(2000)}
    results = set()
    for cmf, flg in sorted(pairs):
        for tail in (b"", b"\x01\x02", b"\x01\x02\x03\x04"):
            data = bytes([cmf, flg]) + tail
            got = _zlib_read(zlib_meta, data)
            assert got == _zlib_read(ref_zlib, data), data
            results.add(got[0] if got[0] == "ok" else got[1])
    for data in (b"", b"\x78"):
        assert _zlib_read(zlib_meta, data) == _zlib_read(ref_zlib, data) == ("reason",
                                                                              "UNEXPECTED_END_OF_STREAM")
    # Every kind of rejection was met: checksum, method, truncated dictionary id.
    assert {"ok", "HEADER_CHECKSUM_MISMATCH", "UNSUPPORTED_COMPRESSION_METHOD",
            "UNEXPECTED_END_OF_STREAM"} <= results


@pytest.mark.parametrize("kw", [{"compression_info": 8}, {"compression_info": 16},
                                {"compression_level": 2}])
def test_zlib_metadata_invalid_fields(kw):
    assert outcome(zlib_meta.ZlibMetadata, **kw)[0] == "raise"
    assert outcome(zlib_meta.ZlibMetadata, **kw) == outcome(ref_zlib.ZlibMetadata, **kw)


# --- gzip headers -------------------------------------------------------------

_GZIP_RECORDS = {
    "plain": {},
    "text_crc": {"is_file_text": True, "has_header_crc": True},
    "all_fields": {"is_file_text": True, "modification_time_unix_s": 1700000000, "extra_flags": 2,
                   "extra_field": b"AB\x02\x00xy", "file_name": "data.bin", "comment": "a comment",
                   "operating_system": "UNIX", "has_header_crc": True},
    "empty_strings": {"modification_time_unix_s": 12345, "extra_field": b"", "file_name": "",
                      "comment": "", "operating_system": "FAT_FILESYSTEM"},
    "negative_mtime": {"modification_time_unix_s": -5, "operating_system": "ACORN_RISCOS"},
    "latin1": {"file_name": "caf\xe9", "comment": "\xff\x01", "extra_flags": 255},
}


def _gzip_make(mod, fields: dict):
    kw = dict(fields)
    if "operating_system" in kw:
        kw["operating_system"] = mod.OperatingSystem[kw["operating_system"]]
    return mod.GzipMetadata(**kw)


def _gzip_fields(meta) -> tuple:
    return (meta.compression_method.name, meta.is_file_text, meta.modification_time_unix_s,
            meta.extra_flags, meta.operating_system.name, meta.extra_field, meta.file_name,
            meta.comment, meta.has_header_crc)


def _gzip_read(mod, data: bytes):
    src = io.BytesIO(data)
    got = outcome(mod.GzipMetadata.read, src)
    if got[0] == "ok":
        return "ok", _gzip_fields(got[1]), src.tell()
    return got


@pytest.mark.parametrize("name", list(_GZIP_RECORDS))
def test_gzip_metadata_write_and_read(name):
    ours, theirs = _gzip_make(gzip_meta, _GZIP_RECORDS[name]), _gzip_make(ref_gzip, _GZIP_RECORDS[name])
    wire = ours.to_bytes()
    assert wire == theirs.to_bytes()
    sink = io.BytesIO()
    ours.write(sink)
    assert sink.getvalue() == wire
    got = _gzip_read(gzip_meta, wire + b"payload")
    assert got == _gzip_read(ref_gzip, wire + b"payload")
    assert got[1] == _gzip_fields(ours) and got[2] == len(wire)
    # Every cut of the header ends the stream early.
    for cut in range(len(wire)):
        assert _gzip_read(gzip_meta, wire[:cut]) == _gzip_read(ref_gzip, wire[:cut]) == (
            "reason", "UNEXPECTED_END_OF_STREAM")


def test_gzip_metadata_rejects_like_reference():
    base = bytearray(gzip_meta.GzipMetadata(file_name="n", has_header_crc=True).to_bytes())
    cases = []
    for b0, b1 in ((0x1F, 0x8C), (0x8B, 0x1F), (0, 0)):
        cases.append(bytes([b0, b1]) + base[2:])
    for cm in (0, 7, 9, 255):
        cases.append(base[:2] + bytes([cm]) + base[3:])
    for flag in (0x20, 0x40, 0x80, 0xE0):
        cases.append(base[:3] + bytes([base[3] | flag]) + base[4:])
    for os_val in (14, 15, 100, 254, 255, 0, 13):
        cases.append(base[:9] + bytes([os_val]) + base[10:])  # the header CRC no longer matches
    cases.append(base[:-1] + bytes([base[-1] ^ 1]))
    cases.append(bytes(base[:-2]) + b"\x00\x00")
    # MTIME with the top bit set reads as a negative int32.
    cases.append(b"\x1f\x8b\x08\x00" + (0xFFFFFFF0).to_bytes(4, "little") + b"\x00\x03")
    seen = set()
    for data in cases:
        got = _gzip_read(gzip_meta, bytes(data))
        assert got == _gzip_read(ref_gzip, bytes(data)), bytes(data)
        seen.add(got[1] if got[0] == "reason" else got[0])
    assert {"ok", "GZIP_INVALID_MAGIC_NUMBER", "UNSUPPORTED_COMPRESSION_METHOD", "GZIP_RESERVED_FLAGS_SET",
            "GZIP_UNSUPPORTED_OPERATING_SYSTEM", "HEADER_CHECKSUM_MISMATCH"} <= seen
    assert gzip_meta.GzipMetadata.read(io.BytesIO(cases[-1])).modification_time_unix_s == -16


@pytest.mark.parametrize("kw", [{"modification_time_unix_s": 0}, {"extra_flags": 256},
                                {"extra_field": bytes(0x10000)}, {"compression_method": 8},
                                {"operating_system": 3}])
def test_gzip_metadata_invalid_fields(kw):
    assert outcome(gzip_meta.GzipMetadata, **kw)[0] == "raise"
    assert outcome(gzip_meta.GzipMetadata, **kw) == outcome(ref_gzip.GzipMetadata, **kw)


# --- checksums ----------------------------------------------------------------

SIZES = [0, 1, 15, 16, 5552, 5553, 65543, 200_000]


@pytest.mark.parametrize("n", SIZES)
def test_adler32_and_crc32_match_reference_and_zlib(n):
    rng = np.random.default_rng(n + 1)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    start = int(rng.integers(0, 1 << 32))
    assert checksum.adler32(data) == ref_ck.adler32(data) == zlib.adler32(data)
    assert checksum.adler32(data, start) == ref_ck.adler32(data, start) == zlib.adler32(data, start)
    assert checksum.adler32(np.frombuffer(data, np.uint8)) == zlib.adler32(data)
    assert checksum.crc32(data, start) == ref_ck.crc32(data, start) == zlib.crc32(data, start)


@pytest.mark.parametrize("seed", range(6))
def test_combines_match_reference_and_zlib(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(0, 70_000))
    cut = int(rng.integers(0, n + 1))
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    a, b = data[:cut], data[cut:]
    got = checksum.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))
    assert got == ref_ck.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b)) == zlib.adler32(data)
    got = checksum.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert got == ref_ck.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(data)


# --- Huffman helpers ----------------------------------------------------------


def _histograms(seed: int, count: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.choice([2, 3, 19, 30, 257, 286, 288]))
        kind = int(rng.integers(0, 3))
        if kind == 0:  # flat
            h = rng.integers(0, 50, n)
        elif kind == 1:  # geometric: long codes that the cap must repair
            h = (2.0 ** rng.uniform(0, 30, n)).astype(np.int64)
        else:  # sparse
            h = np.where(rng.random(n) < 0.2, rng.integers(1, 1000, n), 0)
        if (h > 0).sum() < 2:
            h[:2] = [1, 1]
        out.append(h.astype(np.int64))
    return out


@pytest.mark.parametrize("max_len", [7, 12, 15])
def test_package_merge_and_canonical_codes(max_len):
    for h in _histograms(max_len, 40):
        if (h > 0).sum() > (1 << max_len):
            continue
        ours = huffman.package_merge_lengths(h, max_len)
        np.testing.assert_array_equal(ours, ref_huff.package_merge_lengths(h, max_len))
        assert ours.max() <= max_len
        np.testing.assert_array_equal(huffman.canonical_codes(ours), ref_huff.canonical_codes(ours))
        lut, ref_lut = huffman.build_decode_lut(ours), ref_huff.build_decode_lut(ours)
        np.testing.assert_array_equal(lut.symbol, ref_lut.symbol)
        np.testing.assert_array_equal(lut.length, ref_lut.length)
        assert lut.max_len == ref_lut.max_len
    freqs = np.stack([h[:19] for h in _histograms(77, 24) if h.size >= 19])
    np.testing.assert_array_equal(huffman.huffman_lengths_batch(freqs, 7),
                                  ref_huff.huffman_lengths_batch(freqs, 7))
    assert huffman.LUT_BITS == ref_huff.LUT_BITS


def test_package_merge_rejects_like_reference():
    for h, max_len in ((np.array([0, 5, 0]), 15), (np.ones(9), 3)):
        assert outcome(huffman.package_merge_lengths, h, max_len) == outcome(
            ref_huff.package_merge_lengths, h, max_len) == ("raise", "ValueError")


def test_validate_code_lengths_matches_reference():
    rng = np.random.default_rng(7)
    reasons = set()
    for _ in range(3000):
        n = int(rng.choice([1, 2, 5, 19, 32, 288]))
        lengths = np.where(rng.random(n) < rng.random(), rng.integers(1, 16, n), 0)
        got = outcome(huffman.validate_code_lengths, lengths)
        assert got[0] in ("ok", "reason")
        assert got == outcome(ref_huff.validate_code_lengths, lengths)
        reasons.add(got[1] if got[0] == "reason" else "ok")
    for h in _histograms(3, 20):
        lengths = huffman.package_merge_lengths(h, 15)
        assert outcome(huffman.validate_code_lengths, lengths) == ("ok", None)
    assert {"HUFFMAN_CODE_UNDER_FULL", "HUFFMAN_CODE_OVER_FULL"} <= reasons
    with pytest.raises(DataFormatError):
        huffman.validate_code_lengths(np.array([1]))
