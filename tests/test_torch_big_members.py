"""The port's device route for big and multi-block members on the CPU
(plain versions of the kernels) against the JAX package: the tile split
(``resolve.split_tiles_device`` against ``resolve_pallas.split_tiles_device``
and ``split_tokens_tiles``), the member CRC folded from per-tile registers
and the one-buffer checksums against zlib, and whole gzip streams on
``device_resolve="on"`` against ``gzip_decompress_tpu_v2`` (the reference
resolves in interpret mode) with the same routing counts and Reasons.
Inputs are made from a numpy seed; the pipeline is integer-only, so every
comparison is exact equality."""

from __future__ import annotations

import gzip as pygzip
import zlib

import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import resolve_pallas as rp

from test_torch_decode_slice import _compress, _reason, _structured, _td_member, _zlib_member
from test_torch_resolve import _long_member
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import resolve as rs
from tpu_deflate_torch.kernels import checksum_lanes as cl

CPU = torch.device("cpu")
N = rs.N_POS
MATCH = rs.TOKEN_MATCH_BIT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The tile split
# ---------------------------------------------------------------------------


def _straddlers(tiles: int) -> list[int]:
    """A stream with a 258-run straddling every seam (100 bytes before it)."""
    toks, out = [], 0
    for t in range(tiles):
        lits = (t + 1) * N - 100 - out
        toks += [(out + k) & 0xFF for k in range(lits)] + [MATCH | 258 << 16 | 3]
        out += lits + 258
    return toks + [7, 8]


def _run_on_seam() -> list[int]:
    """A 258-run that ends exactly on the first seam, then a straddler on
    the second: tile 1 gets no head, tile 2 does."""
    toks = [k & 0xFF for k in range(N - 258)] + [MATCH | 258 << 16 | 0]
    toks += [5] * (N - 10) + [MATCH | 200 << 16 | 40] + [1, 2, 3]
    return toks


def _literals(n: int, seed: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def _batch(streams: list[list[int]], seed: int, pad: int) -> np.ndarray:
    """(L, K) int32 with each stream's tokens at sorted random slots and
    -1 elsewhere."""
    rng = np.random.default_rng(seed)
    K = max(len(s) for s in streams) + pad
    out = np.full((len(streams), K), -1, np.int32)
    for i, s in enumerate(streams):
        if s:
            out[i, np.sort(rng.choice(K, len(s), replace=False))] = s
    return out


SPLIT_CASES = {
    # K below N_POS: a short lane, one of only -1, a single literal
    "short": lambda: _batch([_long_member(1, 3000), [], [9]], 1, 40),
    # K above N_POS: a literal-only lane of 1.4 tiles beside a long member
    "long": lambda: _batch([_literals(N + 25000, 2), _long_member(2, 2 * N + 777)], 2, 0),
    "straddlers": lambda: _batch([_straddlers(4), _long_member(3, 100)], 3, 300),
    "run_on_seam": lambda: _batch([_run_on_seam()], 4, 17),
    # lanes of different totals (1, 2, 3, 4 and 5 tiles) in one batch
    "ragged": lambda: _batch([_long_member(10 + t, t * N - 5000) for t in range(1, 6)], 5, 1000),
}


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_tiles_device_matches_reference(case, T):
    tok = SPLIT_CASES[case]()
    got = rs.split_tiles_device(torch.from_numpy(tok), T).numpy()
    np.testing.assert_array_equal(got, np.asarray(rp.split_tiles_device(tok, T)))
    for i in range(tok.shape[0]):
        host = rs.split_tokens_tiles(tok[i])
        t = min(T, host.shape[0])
        np.testing.assert_array_equal(got[i, :t], host[:t])
        assert (got[i, t:] == -1).all()


def test_split_heads_at_seams():
    """Every seam of the straddler lane opens its tile with the match's
    second half (run 158, same distance); the run that ends on a seam
    opens nothing."""
    got = rs.split_tiles_device(torch.tensor([_straddlers(4)], dtype=torch.int32), 5).numpy()[0]
    assert [int(r) for r in got[1:5, 0]] == [MATCH | 158 << 16 | 3] * 4
    seam = rs.split_tiles_device(torch.tensor([_run_on_seam()], dtype=torch.int32), 3).numpy()[0]
    assert seam[1, 0] == 5 and seam[0, N - 258] == MATCH | 258 << 16
    assert seam[1, N - 10] == MATCH | 10 << 16 | 40 and seam[2, 0] == MATCH | 190 << 16 | 40


# ---------------------------------------------------------------------------
# CRC-32 from per-tile registers, and the one-buffer checksums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [1, N - 1, N, N + 1, 3 * N, 3 * N + 12345])
def test_crc_fold_matches_zlib(total):
    data = np.random.default_rng(total).integers(0, 256, total, dtype=np.uint8)
    T = -(-total // N)
    rows = np.zeros(T * N, np.uint8)
    rows[:total] = data
    raws = cl.crc32_lanes_raw8(torch.from_numpy(rows).view(T, N)).numpy()
    got = cl.crc32_fold_tiles(raws[None], np.array([total]), N)
    assert int(got[0]) == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 1000, 70000, 600000])
def test_crc32_adler32_device_match_zlib(n):
    """The sizes of the reference's test_crc32_device_matches_zlib, and one
    buffer wider than the lane CRC's widest row."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert cl.crc32_device(data, device=CPU) == zlib.crc32(data)
    assert cl.adler32_device(data, device=CPU) == zlib.adler32(data)


def test_crc32_adler32_device_with_init_value():
    data = b"hello, deflate world" * 17
    mid = len(data) // 2
    assert cl.crc32_device(data[mid:], zlib.crc32(data[:mid]), device=CPU) == zlib.crc32(data)
    assert cl.adler32_device(data[mid:], zlib.adler32(data[:mid]), device=CPU) == zlib.adler32(data)


def test_checksum_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cl.crc32_device(b"abc")
    with pytest.raises(RuntimeError, match="CUDA"):
        cl.adler32_device(b"abc")


# ---------------------------------------------------------------------------
# The route on device_resolve="on"
# ---------------------------------------------------------------------------


def _copies(n: int, seed: int) -> bytes:
    """4 KiB of random letters, then copies of its substrings (30 to 250
    bytes from random offsets), a random letter after each: zlib -9 codes
    each copy as one match, so 200 KB take about 7 KB of payload."""
    rng = np.random.default_rng(seed)
    base = rng.integers(97, 123, 4096, dtype=np.uint8)
    parts, total = [base], base.size
    while total < n:
        off, ln = int(rng.integers(0, 4096 - 250)), int(rng.integers(30, 251))
        parts += [base[off : off + ln], rng.integers(97, 123, 1, dtype=np.uint8)]
        total += ln + 1
    return np.concatenate(parts).tobytes()[:n]


def _runs(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 4, n // 64, dtype=np.uint8), rng.integers(1, 512, n // 64))[:n].tobytes()


def _raw9(data: bytes, zdict: bytes | None = None, flush: int = zlib.Z_FINISH) -> bytes:
    """zlib -9 raw DEFLATE at memLevel 5, which ends a block every 2047
    symbols: the members stay multi-block while each payload stays in the
    smallest wave bucket, so the reference compiles few wave shapes."""
    kw = {"zdict": zdict} if zdict else {}
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 5, **kw)
    return co.compress(data) + co.flush(flush)


def _member9(data: bytes) -> bytes:
    return _td_member(_raw9(data), len(data), zlib.crc32(data))


def _spliced() -> tuple[bytes, bytes]:
    """One member: Huffman blocks of A (ending in a sync flush), a stored
    block of S, then a zlib raw stream of B whose matches reach back into
    A and S through its preset dictionary. Returns (member, output)."""
    a, s, b = _copies(40000, 41), _runs(4000, 42), _copies(100_000, 43)
    stored = b"\x00" + len(s).to_bytes(2, "little") + (len(s) ^ 0xFFFF).to_bytes(2, "little") + s
    payload = _raw9(a, flush=zlib.Z_SYNC_FLUSH) + stored + _raw9(b, zdict=(a + s)[-32768:])
    data = a + s + b
    return _td_member(payload, len(data), zlib.crc32(data)), data


def _first_block(member: bytes) -> tuple[int, int]:
    hdr = member[20]  # the TD header is 20 bytes
    return hdr & 1, (hdr >> 1) & 3


def _route_stream() -> tuple[bytes, int]:
    """A main-path member, then four members of different T in one batch:
    exactly 2 x 64 KiB (T 2), the spliced member of 144 KB (T 3), a zlib
    -9 member of 200 KB in 4 blocks (T 4) and a single-block member of 300
    KB (T 5). Each T holds one lane, so the reference compiles its resolve
    for one lane only. Returns (stream, Huffman members)."""
    main = _compress(_structured(40, 50_000))
    assert len(pv2.dnp.split_members(np.frombuffer(main, np.uint8))) == 1
    single = _zlib_member(_runs(300_000, 44))
    assert _first_block(single) == (1, 2)
    spliced, _ = _spliced()
    assert _first_block(spliced)[1] != 0
    members = [main, _member9(_copies(2 * N, 47)), spliced, _member9(_copies(200_000, 46)), single]
    return b"".join(members), len(members)


def _check_on(gz: bytes, n_huff: int) -> dict:
    got = pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on")
    stats = dict(pv2.LAST_DECODE_STATS)
    want = v2.gzip_decompress_tpu_v2(gz, device_resolve="on")
    assert got == want == pygzip.decompress(gz)
    for k in ("members", "stored", "device_resolved", "host_resolved"):
        assert stats[k] == v2.LAST_DECODE_STATS[k], k
    assert stats["device_resolved"] == n_huff and stats["host_resolved"] == 0
    return stats


def test_route_on_matches_reference():
    gz, n_huff = _route_stream()
    stats = _check_on(gz, n_huff)
    assert (stats["chained_tiles"], stats["chained_groups"]) == (2 + 3 + 4 + 5, 4)
    assert stats["launches"]["compact_any"] == 0


def test_route_memory_bound(monkeypatch):
    """With the bound at two tiles, the three members of at most two tiles
    run one to a device-route batch and the 3-, 4- and 5-tile members take
    the host route (K7 pull, C-core resolve) in one batch, in stream
    order; no device-route batch pulls its tokens through K7."""
    gz, n_huff = _route_stream()
    gz += _member9(_copies(2 * N - 1000, 48)) + _member9(_structured(49, 2 * N - 7))
    monkeypatch.setattr(pv2, "BIG_BATCH_POSITIONS", 2 * N)
    batches, pulls = [], []
    chain, pack = pv2._decode_streams, pv2.pack_tokens

    def chain_spy(payloads, runner, stats, device_caps):
        batches.append((len(payloads), device_caps is not None))
        return chain(payloads, runner, stats, device_caps)

    def pack_spy(tokens):
        pulls.append(batches[-1][1])
        return pack(tokens)

    monkeypatch.setattr(pv2, "_decode_streams", chain_spy)
    monkeypatch.setattr(pv2, "pack_tokens", pack_spy)
    got = pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on")
    stats = pv2.LAST_DECODE_STATS
    assert got == pygzip.decompress(gz)
    assert batches == [(1, True), (3, False), (1, True), (1, True)]
    assert pulls and not any(pulls)
    assert (stats["device_resolved"], stats["host_resolved"]) == (1 + 3, n_huff - 2)
    assert (stats["chained_tiles"], stats["chained_groups"]) == (3 * 2, 3)


class _M:
    def __init__(self, isize):
        self.isize = isize


@pytest.mark.parametrize(
    "isizes,batch_n,want",
    [
        # claims add up to the bound, then one past it starts a new batch
        ([4, 4, 1, 3], 8, [[0, 1], [2, 3]]),
        # a member above the bound takes the host route alone, in order
        ([2, 9, 2, 2], 8, [[0], [1], [2, 3]]),
        # host-route members batch together; batch_n caps every batch
        ([9, 9, 9, 1, 1, 1], 2, [[0, 1], [2], [3, 4], [5]]),
        # without the device route every member is a host-route member
        ([9, 1, 1], None, [[0, 1, 2]]),
    ],
)
def test_chain_batches(monkeypatch, isizes, batch_n, want):
    monkeypatch.setattr(pv2, "BIG_BATCH_POSITIONS", 8)
    huff = [(i, _M(n)) for i, n in enumerate(isizes)]
    got = list(pv2._chain_batches(huff, batch_n or 8, batch_n is not None))
    assert [[i for i, _m in b] for b, _d in got] == want
    assert [d for _b, d in got] == [batch_n is not None and isizes[b[0][0]] <= 8 for b, _d in got]


def test_lane_past_its_isize_leaves_the_device(monkeypatch):
    """A member whose blocks expand far past the ISIZE its trailer claims:
    its tokens come to the host once its output passes the claim, the
    chained resolve never runs on it, and it fails with the reference's
    Reason."""
    data = _copies(200_000, 46)
    gz = _td_member(_raw9(data), 5000, zlib.crc32(data))
    seen = []
    chain = pv2._decode_streams

    def chain_spy(*a, **kw):
        states = chain(*a, **kw)
        seen.extend(states)
        return states

    def no_resolve(tiles):
        raise AssertionError("the chained resolve ran on a lane past its ISIZE")

    monkeypatch.setattr(pv2, "_decode_streams", chain_spy)
    monkeypatch.setattr(rs, "resolve_tiles_crc", no_resolve)
    got = _reason(lambda b: pv2.gzip_decompress_v2(b, device=CPU, device_resolve="on"), gz)
    want = _reason(lambda b: v2.gzip_decompress_tpu_v2(b, device_resolve="on"), gz)
    assert got == want == "DECOMPRESSED_SIZE_MISMATCH"
    (st,) = seen
    assert st.out_total == len(data) and len(st.tokens) > 1
    assert not any(isinstance(s, torch.Tensor) for s in st.tokens)


def test_route_overflow_rerun_keeps_tokens_on_device(monkeypatch):
    """A member of 1- and 2-bit literal codes overflows the wave's k1; the
    k1 = 512 rerun's tokens stay on the device and resolve there."""
    k1s = []
    run_wave = pv2.run_wave

    def spy(w, *, k1=None):
        k1s.append(k1)
        return run_wave(w, k1=k1)

    monkeypatch.setattr(pv2, "run_wave", spy)
    data = bytes([0, 1]) * 40000
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    gz = _td_member(co.compress(data) + co.flush(), len(data), zlib.crc32(data))
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on") == data
    assert (pv2.LAST_DECODE_STATS["device_resolved"], pv2.LAST_DECODE_STATS["chained_tiles"]) == (1, 2)
    assert pv2.W_P in k1s


def _bad_distance_member() -> bytes:
    """A multi-block member whose second block copies from its preset
    dictionary, which the decoder never saw: the first distance reaching
    before the start lies in a later block."""
    d = _copies(32768, 51)
    payload = _raw9(b"head " * 60, flush=zlib.Z_SYNC_FLUSH) + _raw9(d[-20000:] + _copies(30000, 52), zdict=d)
    return _td_member(payload, 50300, 0)


def _corrupt(where: str) -> bytes:
    """The 200 KB multi-block member (4 blocks, 4 tiles), broken late: a
    flipped byte in its last block (a wrong literal: the CRC catches it),
    its payload cut in its last block (a stage error in tile 3: the lane
    takes the host route), or a flipped CRC or ISIZE."""
    data = _copies(200_000, 46)
    if where == "truncated":
        raw = _raw9(data)
        return _td_member(raw[: len(raw) * 9 // 10], len(data), zlib.crc32(data))
    gz = bytearray(_member9(data))
    at = {"late_block": 20 + (len(gz) - 28) * 17 // 20, "crc": len(gz) - 8, "isize": len(gz) - 4}[where]
    gz[at] ^= 0x55
    return bytes(gz)


@pytest.mark.parametrize("where", ["late_block", "truncated", "bad_distance", "crc", "isize"])
def test_route_corruption_same_reason(where):
    gz = _bad_distance_member() if where == "bad_distance" else _corrupt(where)
    got = _reason(lambda b: pv2.gzip_decompress_v2(b, device=CPU, device_resolve="on"), gz)
    want = _reason(lambda b: v2.gzip_decompress_tpu_v2(b, device_resolve="on"), gz)
    assert got is not None and got == want


def test_error_position_in_a_late_tile_hands_back():
    """A lane whose only error position (a distance past 32 KiB: a valid
    stream cannot reach before the start after its first 32 KiB) lies in
    tile 2 goes back to the host route, as the reference's
    resolve_big_streams hands it back; a clean lane beside it resolves
    with its CRC."""
    clean = _long_member(61, 2 * N + 3000)
    bad = _long_member(62, 2 * N + 500) + [MATCH | 9 << 16 | 0x8000, 65]
    states = []
    for toks in (clean, bad):
        arr = np.array(toks, np.int32)
        st = pv2.LaneState(b"", tokens=[torch.from_numpy(arr[:5000]), arr[5000:]], device_cap=1 << 20)
        st.out_total = int(np.where((arr & MATCH) != 0, (arr >> 16) & 0x3FF, 1).sum())
        states.append(st)
    outs = pv2._decode_chained_device(states, [st.out_total for st in states], True, pv2.WaveRunner.on(CPU), {})
    want = rp.resolve_reference(np.array(clean, np.int64))
    assert outs[0] == (want, zlib.crc32(want)) and outs[1] is None
    # one stream a call: the reference's resolve keeps the one-lane shape it compiled for the route
    resid = [rp.resolve_big_streams([np.array(t, np.int32)], interpret=True)[1][0] for t in (clean, bad)]
    assert resid[0] == 0 and resid[1] > 0
    assert states[0].tokens == [] and len(states[1].tokens) == 1  # kept for the host route
