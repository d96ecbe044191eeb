"""Parts of the port's continuous-history encode against the JAX package:
the analysis of halo rows (``encode.analyze`` with ``hist``/``hstart``)
field for field against ``encode_jax.analyze_device``; the bit splicer
against ``encode_jax._BitSplicer``; the reference's faults F1, F2 and F11,
where the port's stream round-trips through gzip and zlib and the
reference's does not; and the front door: effort routing, ``config=`` and
the leading metadata member against the reference's ``_prepend_metadata``.
Inputs are made from numpy seeds; the pipeline is integer-only, so the
tolerance is exact equality."""

from __future__ import annotations

import gzip
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_deflate.engine as ref_engine
from tpu_deflate.codec import encode_jax as ej
from tpu_deflate.config import EncoderConfig as RefEncoderConfig
from tpu_deflate.config import FrameworkConfig as RefFrameworkConfig
from tpu_deflate.format import gzip_meta as ref_meta
from tpu_deflate_torch import engine
from tpu_deflate_torch.codec import continuous as pc
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.config import EncoderConfig
from tpu_deflate_torch.format import gzip_meta

CPU = torch.device("cpu")
BLOCK = 4096
H = pc.HALO_COLS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 122, rng.integers(3, 9)).astype(np.uint8)) for _ in range(60)]
    out = b" ".join(words[int(i)] for i in rng.integers(0, 60, 4 * n // 5))
    return out[:n]


def _history_edge_data() -> np.ndarray:
    """Text of 12 blocks in which a run of 'q' ends on the last halo byte of
    lane 3 (a match in the history that stops at the payload), and a run
    of 'z' crosses lane 6's payload start (a match that enters it)."""
    flat = np.frombuffer(_text(12 * BLOCK, seed=21), np.uint8).copy()
    flat[3 * BLOCK - 300 : 3 * BLOCK] = ord("q")
    flat[6 * BLOCK - 200 : 6 * BLOCK + 150] = ord("z")
    return flat


def _reference_rows(flat: np.ndarray, lanes: list[int]):
    """Halo rows of the given lanes, built as compress_continuous_tpu builds
    them: (rows, hstart, pay_lens)."""
    n = flat.size
    rows = np.zeros((len(lanes), H + BLOCK), np.uint8)
    hstart = np.full(len(lanes), H, np.int32)
    pay_lens = np.zeros(len(lanes), np.int32)
    for i, l in enumerate(lanes):
        p0 = l * BLOCK
        pay = flat[p0 : p0 + BLOCK]
        h = min(H, p0)
        rows[i, H - h : H] = flat[p0 - h : p0]
        rows[i, H : H + pay.size] = pay
        hstart[i] = H - h
        pay_lens[i] = pay.size
    return rows, hstart, pay_lens


def test_lane_rows_are_the_references():
    flat = _history_edge_data()
    for first, count in ((0, 4), (6, 6)):
        rows, hstart, pay_lens = _reference_rows(flat, list(range(first, first + count)))
        got = pc.lane_rows(flat, first, count, BLOCK)
        for g, w in zip(got, (rows, hstart, pay_lens)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[3], np.arange(first, first + count) == 11)


@pytest.mark.parametrize("lazy,quality", [(False, 0), (True, 0), (False, 1), (True, 1), (False, 2),
                                          (True, 2)])
def test_analysis_matches_reference(lazy, quality):
    """The head lane, a mid lane, and the lanes whose history ends inside a
    run: every field, is-token (the parse entering the payload at column
    32768 exactly) and the histograms included."""
    rows, hstart, pay_lens = _reference_rows(_history_edge_data(), [0, 2, 3, 6])
    L = rows.shape[0]
    lengths = (H + pay_lens).astype(np.int32)
    hist = np.full(L, H, np.int32)
    want = ej.analyze_device(jnp.asarray(rows), jnp.asarray(lengths), lazy, quality, jnp.asarray(hist),
                             jnp.asarray(hstart))
    got = pe.analyze(torch.from_numpy(rows), torch.from_numpy(lengths), lazy, quality,
                     torch.from_numpy(hist), torch.from_numpy(hstart))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    tok = got["is_token"].numpy()
    assert not tok[:, :H].any() and tok[:, H].all()


def _fails(gz: bytes, data: bytes) -> bool:
    try:
        return gzip.decompress(gz) != data
    except (OSError, EOFError, zlib.error):
        return True


def _f1_input() -> bytes:
    return b"\x00" * 50 + _text(17000)


def _f2_input() -> bytes:
    return np.random.default_rng(5).integers(0, 128, 300000, dtype=np.uint8).tobytes()


def _f11_input() -> bytes:
    pattern = np.random.default_rng(11).integers(0, 256, 1000, dtype=np.uint8)
    return np.tile(pattern, 525)[: 512 * 1024].tobytes()


@pytest.mark.parametrize(
    "data_fn,block_data",
    [(_f1_input, BLOCK), (_f2_input, 131072), (_f11_input, 262144)],
    ids=["F1_leading_zeros", "F2_grid_overflow", "F11_far_candidates"],
)
def test_reference_faults_repaired(data_fn, block_data):
    """F1: the head lane's RLE lanes matched the halo's zero padding
    ("distance too far back"). F2: blocks of 7-bit bytes of 128 KiB code to
    more bits than the emit's word grid and less than stored, and the
    reference spliced the truncated words. F11: candidates past column
    2**18 - 2 ran into the length field of the packed best match."""
    data = data_fn()
    got = pc.compress_continuous(data, device=CPU, effort=4, block_data=block_data)
    assert gzip.decompress(got) == data
    assert zlib.decompress(got, 16 + zlib.MAX_WBITS) == data
    ref = ej.compress_continuous_tpu(data, effort=4, block_data=block_data)
    assert _fails(ref, data), "the reference's stream round-trips: the fault did not fire"


def test_f2_overflowing_lanes_are_stored():
    """The F2 input's full lanes take more bits than the grid holds and
    are spliced as stored; its short last lane stays Huffman."""
    flat = np.frombuffer(_f2_input(), np.uint8)
    rows, hstart, pay_lens, final = pc.lane_rows(flat, 0, 3, 131072)
    _words, total_bits, choice = pc.continuous_encode_lanes(
        torch.from_numpy(rows), torch.from_numpy(hstart), pay_lens, final, True, 1)
    bits = total_bits.numpy()
    assert (bits[:2] > 32 * pc.EMIT_WORDS).all() and (choice.numpy()[:2] != pe.ROUTE_STORED).all()
    assert bits[2] <= 32 * pc.EMIT_WORDS


@pytest.mark.parametrize("offset", range(8))
def test_bit_splicer_matches_reference(offset):
    """Huffman-style and stored appends at every bit offset, final and not,
    including stored data that splits at 65535 bytes."""
    rng = np.random.default_rng(offset)
    ours, theirs = pc.BitSplicer(), ej._BitSplicer()
    for sp in (ours, theirs):
        sp.append(bytes([0x5A]), 0)
    lead = rng.integers(0, 256, 3, dtype=np.uint8)
    lead_bits = 16 + offset
    lead[2] &= (1 << offset) - 1
    stored = rng.integers(0, 256, 70000, dtype=np.uint8)
    steps = [("bits", lead.tobytes(), lead_bits), ("stored", stored[:300], False),
             ("bits", bytes([0b101]), 3), ("stored", stored, False), ("bits", bytes([0x7F]), 7),
             ("stored", stored[:1], True), ("bits", bytes([1]), 1), ("stored", stored[:0], True)]
    for kind, payload, arg in steps:
        if kind == "bits":
            ours.append(payload, arg)
            theirs.append(payload, arg)
        else:
            ours.append_stored(payload.tobytes(), arg)
            theirs.append_stored(payload, arg)
        assert ours.bitpos == theirs.bitpos
        assert ours.payload() == theirs.payload()


@pytest.fixture
def cpu_engine(monkeypatch):
    """engine.compress on the CPU: the device it asks for becomes the CPU."""
    monkeypatch.setattr(engine, "_cuda", lambda name: CPU)


def test_engine_routes_effort_to_continuous(cpu_engine):
    data = _text(9000, seed=11)
    assert engine.compress(data, effort=4) == pc.compress_continuous(data, device=CPU, effort=4)
    small = EncoderConfig(lookahead=BLOCK)
    want5 = pc.compress_continuous(data, device=CPU, effort=5, block_data=BLOCK)
    assert engine.compress(data, config=small, effort=5) == want5
    # The JAX package's configs work too; an explicit effort wins over theirs.
    ref_cfg = RefFrameworkConfig(encoder=RefEncoderConfig(lookahead=BLOCK, effort=5))
    assert engine.compress(data, config=ref_cfg) == want5
    assert engine.compress(data, config=ref_cfg, effort=2) == pe.compress_members(data, device=CPU, effort=2)


_RECORDS = {
    "plain": {},
    "header_crc": {"has_header_crc": True},
    "all_fields": {"is_file_text": True, "modification_time_unix_s": 1700000000, "extra_flags": 2,
                   "extra_field": b"AB\x02\x00xy", "file_name": "data.bin", "comment": "a comment"},
    "all_fields_crc": {"modification_time_unix_s": 12345, "extra_field": b"", "file_name": "f",
                       "comment": "", "has_header_crc": True},
}


@pytest.mark.parametrize("name", list(_RECORDS))
def test_metadata_member_matches_reference(name):
    fields = _RECORDS[name]
    os_kw = {"operating_system": gzip_meta.OperatingSystem.UNIX} if name == "all_fields" else {}
    ref_os = {"operating_system": ref_meta.OperatingSystem.UNIX} if os_kw else {}
    ours = gzip_meta.GzipMetadata(**fields, **os_kw)
    theirs = ref_meta.GzipMetadata(**fields, **ref_os)
    assert ours.to_bytes() == theirs.to_bytes()
    body = gzip.compress(b"payload")
    want = ref_engine._prepend_metadata(body, theirs)
    assert engine._prepend_metadata(body, ours) == want
    assert engine._prepend_metadata(body, theirs) == want
    assert gzip.decompress(want) == b"payload"


@pytest.mark.parametrize("effort", [2, 4])
def test_engine_metadata_on_both_paths(cpu_engine, effort):
    data = _text(6000, seed=4)
    meta = gzip_meta.GzipMetadata(file_name="log.txt", has_header_crc=True)
    out = engine.compress(data, effort=effort, metadata=meta)
    body = engine.compress(data, effort=effort)
    assert out == ref_engine._prepend_metadata(body, ref_meta.GzipMetadata(file_name="log.txt",
                                                                           has_header_crc=True))
    assert gzip.decompress(out) == data
