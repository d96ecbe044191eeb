"""The port's streams and one-shot API against the JAX package's and
Python's: ``GzipWriter``/``GzipReader`` with metadata, multi-member input
and trailing bytes; ``ZlibWriter``/``ZlibReader`` with and without a preset
dictionary; ``InflaterReader.detach``, ``MarkableFileStream`` and the
stream discipline (a write after ``finish`` raises); the one-shot API at
efforts 0-5 byte-identical to ``tpu_deflate.*``; Python's ``gzip`` and
``zlib`` modules in both directions. Reads and writes go in seeded random
chunk sizes; every comparison is exact."""

from __future__ import annotations

import gzip
import io
import zlib

import numpy as np
import pytest

import tpu_deflate as ref
from tpu_deflate.format import gzip_meta as ref_gzip_meta
import tpu_deflate_torch as port
from tpu_deflate_torch.format import gzip_meta
from tpu_deflate_torch.streams.gzip_stream import GzipReader, GzipWriter
from tpu_deflate_torch.streams.inflater import InflaterReader
from tpu_deflate_torch.streams.markable import MarkableFileStream
from tpu_deflate_torch.streams.zlib_stream import ZlibReader, ZlibWriter


def data_of(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(100)]
    text = np.concatenate([words[i] for i in rng.integers(0, 100, n // 3 + 1)])[: n - n // 5]
    return text.tobytes() + bytes(n // 10) + rng.integers(0, 256, n - len(text) - n // 10,
                                                          dtype=np.uint8).tobytes()


def outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "raise", getattr(getattr(e, "reason", None), "name", type(e).__name__)


def write_chunks(writer, data: bytes, seed: int) -> None:
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(data):
        n = int(rng.integers(1, 5000))
        writer.write(data[pos : pos + n])
        pos += n
    writer.finish()


def read_chunks(reader, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    out = bytearray()
    while chunk := reader.read(int(rng.integers(1, 3000))):
        out += chunk
    return bytes(out)


# --- gzip ---------------------------------------------------------------------

METAS = {
    "none": None,
    "name_crc": {"file_name": "a.txt", "has_header_crc": True, "modification_time_unix_s": 1234567890},
    "all": {"is_file_text": True, "extra_flags": 4, "extra_field": b"XY\x01\x00z", "comment": "c",
            "operating_system": "UNIX", "file_name": "f"},
}


def _meta(mod, name):
    fields = METAS[name]
    if fields is None:
        return None
    kw = dict(fields)
    if "operating_system" in kw:
        kw["operating_system"] = mod.OperatingSystem[kw["operating_system"]]
    return mod.GzipMetadata(**kw)


@pytest.mark.parametrize("meta", list(METAS))
@pytest.mark.parametrize("effort", [0, 1, 2])
def test_gzip_writer_and_reader(meta, effort):
    data = data_of(12000, seed=effort)
    sinks = []
    for writer, gm, api in ((GzipWriter, gzip_meta, port), (ref.GzipWriter, ref_gzip_meta, ref)):
        sink = io.BytesIO()
        write_chunks(writer(sink, _meta(gm, meta), strategy=api.strategy_for_effort(effort), lookahead=8192),
                     data, seed=effort)
        sinks.append(sink.getvalue())
    gz = sinks[0]
    assert gz == sinks[1]
    assert gzip.decompress(gz) == data
    reader = GzipReader(io.BytesIO(gz))
    assert read_chunks(reader, seed=3) == data
    if meta != "none":
        assert reader.metadata == _meta(gzip_meta, meta)


def _members(seed: int) -> list[bytes]:
    return [data_of(n, seed + i) for i, n in enumerate((5000, 0, 12000, 1))]


@pytest.mark.parametrize("tail", [b"", b"\x00", b"\x1f\x8b\x08", b"garbage!"])
@pytest.mark.parametrize("multi", [True, False])
def test_gzip_reader_members_and_trailing_bytes(tail, multi):
    parts = _members(7)
    gz = b"".join(port.gzip_compress(p, effort=1, engine="host") for p in parts) + tail
    for seed in (1, 2):
        got = outcome(read_chunks, GzipReader(io.BytesIO(gz), multi_member=multi), seed)
        assert got == outcome(read_chunks, ref.GzipReader(io.BytesIO(gz), multi_member=multi), seed)
    assert outcome(port.gzip_decompress, gz, multi_member=multi, engine="host") == outcome(
        ref.gzip_decompress, gz, multi_member=multi)
    if multi and not tail:
        assert got == ("ok", b"".join(parts))
    if not multi:
        assert got == ("ok", parts[0])


@pytest.mark.parametrize("cut", [0, 5, 11, -9, -5, -1])
def test_gzip_reader_truncated_and_corrupted(cut):
    data = data_of(9000, seed=11)
    gz = port.gzip_compress(data, effort=2, engine="host")
    cases = [gz[:cut]]
    for at in (len(gz) - 8, len(gz) - 4, 20):
        bad = bytearray(gz)
        bad[at + cut % 3] ^= 0x10
        cases.append(bytes(bad))
    for c in cases:
        got = outcome(port.gzip_decompress, c, engine="host")
        assert got == outcome(ref.gzip_decompress, c)
        assert got[0] == "raise" or got == ("ok", data)


# --- zlib ---------------------------------------------------------------------


@pytest.mark.parametrize("dictionary", [None, b"", b"the dictionary, a few words long " * 50],
                         ids=["none", "empty", "words"])
@pytest.mark.parametrize("effort", [0, 1, 2])
def test_zlib_writer_and_reader(dictionary, effort):
    data = data_of(8000, seed=20 + effort)
    outs = []
    for writer, api in ((ZlibWriter, port), (ref.ZlibWriter, ref)):
        sink = io.BytesIO()
        write_chunks(writer(sink, strategy=api.strategy_for_effort(effort), preset_dictionary=dictionary,
                            lookahead=4096), data, seed=effort)
        outs.append(sink.getvalue())
    z = outs[0]
    assert z == outs[1]
    zd = zlib.decompressobj(zdict=dictionary) if dictionary is not None else zlib.decompressobj()
    assert zd.decompress(z) + zd.flush() == data
    r = ZlibReader(io.BytesIO(z + b"after"), preset_dictionary=dictionary)
    assert read_chunks(r, seed=effort) == data
    assert r.metadata.preset_dictionary == (zlib.adler32(dictionary) if dictionary is not None else None)
    assert port.zlib_decompress(z, preset_dictionary=dictionary, engine="host") == data


def test_zlib_reader_rejects_like_reference():
    data = data_of(6000, seed=30)
    d = b"some preset dictionary"
    z = port.zlib_compress(data, preset_dictionary=d, engine="host")
    plain = port.zlib_compress(data, engine="host")
    cases = [(z, None), (z, b"other"), (z, d), (plain, d), (plain[:1], None), (plain[:-1], None),
             (plain[:-4], None), (plain[:-1] + bytes([plain[-1] ^ 1]), None), (b"\x78\x9c" + plain[2:], None),
             (b"\x77\x9c" + plain[2:], None), (bytes([plain[0] & 0xF0 | 7, plain[1]]) + plain[2:], None)]
    for stream, dictionary in cases:
        got = outcome(port.zlib_decompress, stream, preset_dictionary=dictionary, engine="host")
        assert got == outcome(ref.zlib_decompress, stream, preset_dictionary=dictionary)
    assert outcome(port.zlib_decompress, z, engine="host") == ("raise", "ValueError")
    assert outcome(port.zlib_decompress, z, preset_dictionary=b"other", engine="host") == ("raise", "HEADER_CHECKSUM_MISMATCH")
    with pytest.raises(ValueError):
        ZlibWriter(io.BytesIO(), port.ZlibMetadata(preset_dictionary=1), preset_dictionary=d)


# --- stream shells ------------------------------------------------------------


def test_inflater_detach_and_markable(tmp_path):
    data = data_of(7000, seed=40)
    raw = port.deflate(data, effort=1, engine="host")
    r = InflaterReader(io.BytesIO(raw + b"TAIL"), end_exactly=True, buffer_size=3)
    assert read_chunks(r, seed=1) == data
    assert r.detach().read() == b"TAIL"
    assert outcome(InflaterReader(io.BytesIO(raw)).detach) == ("raise", "ValueError")
    assert outcome(InflaterReader, io.BytesIO(raw), buffer_size=0) == ("raise", "ValueError")
    assert InflaterReader(io.BytesIO(raw)).read1() == data[0]

    path = tmp_path / "m.bin"
    path.write_bytes(b"0123456789")
    for src in (str(path), open(path, "rb")):
        m = MarkableFileStream(src)
        assert m.markSupported()
        assert m.read(2) == b"01"
        m.mark()
        assert m.read(3) == b"234"
        m.reset()
        assert m.skip(4) == 4 and m.read() == b"6789"
        m.close()


@pytest.mark.parametrize("kind", ["deflater", "gzip", "zlib"])
def test_write_after_finish_raises(kind):
    sink = io.BytesIO()
    w = {"deflater": lambda: port.Deflater(sink), "gzip": lambda: GzipWriter(sink),
         "zlib": lambda: ZlibWriter(sink)}[kind]()
    w.write(b"abc")
    w.finish()
    with pytest.raises(ValueError):
        w.write(b"more")
    with pytest.raises(ValueError):
        w.finish()
    w.close()


# --- one-shot API and Python's modules ------------------------------------------


@pytest.mark.parametrize("effort", range(6))
def test_one_shot_api_matches_reference(effort):
    data = data_of(4000 if effort == 5 else 8000, seed=50 + effort)
    meta = port.GzipMetadata(file_name="x", operating_system=port.OperatingSystem.UNIX)
    ref_meta = ref.GzipMetadata(file_name="x", operating_system=ref.OperatingSystem.UNIX)
    gz = port.gzip_compress(data, effort=effort, metadata=meta, engine="host")
    assert gz == ref.gzip_compress(data, effort=effort, metadata=ref_meta)
    z = port.zlib_compress(data, effort=effort, engine="host")
    assert z == ref.zlib_compress(data, effort=effort)
    assert port.gzip_decompress(gz, engine="host") == gzip.decompress(gz) == data
    assert port.zlib_decompress(z, engine="host") == zlib.decompress(z) == data


def test_exports_match_reference():
    names = [n for n in dir(ref) if not n.startswith("_") and n not in ("annotations", "io")]
    assert not [n for n in names if not hasattr(port, n)]
    assert port.__version__ == ref.__version__
    assert sorted(port._EFFORT_STRATEGIES) == sorted(ref._EFFORT_STRATEGIES)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_reads_python_streams(level):
    data = data_of(30000, seed=60 + level)
    two = gzip.compress(data, level) + gzip.compress(data[:100], level, mtime=0)
    assert port.gzip_decompress(two, engine="host") == data + data[:100]
    assert read_chunks(GzipReader(io.BytesIO(gzip.compress(data, level)), multi_member=True), seed=level) == data
    assert port.zlib_decompress(zlib.compress(data, level), engine="host") == data
    zd = b"a zlib preset dictionary " * 20
    co = zlib.compressobj(level, zdict=zd)
    assert port.zlib_decompress(co.compress(data) + co.flush(), preset_dictionary=zd, engine="host") == data
    raw = zlib.compressobj(level, zlib.DEFLATED, -15)
    assert port.inflate(raw.compress(data) + raw.flush()) == data
