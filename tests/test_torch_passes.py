"""Members above the device route's batch bound, resolved in passes over one
lane (``decode_v2._resolve_passes``), on the CPU with the plain versions of
the kernels: ``BIG_BATCH_POSITIONS``, and with it the pass, is lowered to
one or two tiles, so small members take the pass route and every seam of a
pass is exercised. Whole gzip streams on ``device_resolve="on"`` against
the JAX package's ``gzip_decompress_tpu_v2`` (which has no passes: its
device resolve takes any size) and ``gzip.decompress``, with the same
routing counts and Reasons; hand-made lanes against the reference's
serial resolve, tile split and zlib's CRC. Inputs are made from a numpy
seed; the pipeline is integer-only, so every comparison is exact
equality."""

from __future__ import annotations

import gzip as pygzip
import zlib

import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import resolve_pallas as rp

from test_torch_big_members import (
    _copies,
    _corrupt,
    _member9,
    _raw9,
    _run_on_seam,
    _runs,
    _spliced,
    _straddlers,
)
from test_torch_decode_slice import _compress, _reason, _structured, _td_member, _zlib_member
from test_torch_resolve import _long_member
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import resolve as rs
from tpu_deflate_torch.dist.mesh import make_codec_mesh

CPU = torch.device("cpu")
N = rs.N_POS
MATCH = rs.TOKEN_MATCH_BIT
STAT_KEYS = ("members", "stored", "device_resolved", "host_resolved")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lower(monkeypatch, tiles: int) -> None:
    """A batch bound, and so a pass, of ``tiles`` tiles."""
    monkeypatch.setattr(pv2, "BIG_BATCH_POSITIONS", tiles * N)


def _split_spy(monkeypatch) -> list:
    """Record (T, the tiles) of every tile split."""
    seen = []
    split = rs.split_tiles_device

    def spy(tokens, T):
        out = split(tokens, T)
        seen.append((T, out))
        return out

    monkeypatch.setattr(rs, "split_tiles_device", spy)
    return seen


# ---------------------------------------------------------------------------
# Whole streams on device_resolve="on"
# ---------------------------------------------------------------------------


def _pass_stream() -> tuple[bytes, list[int]]:
    """A main-path member, a small multi-block member, then members above a
    bound of one or two tiles: a zlib -9 member of 200 KB in 4 blocks, a
    single-block member of 300 KB, the spliced member with its stored block
    across the seam at 2 x 64 KiB, and a zlib -9 member of exactly 2 x 64
    KiB. Returns (stream, the ISIZE of each Huffman member)."""
    spliced, data = _spliced(2 * N - 1500)
    assert 2 * N - 1500 < 2 * N < 2 * N + 2500  # the stored block's 4000 bytes span the seam
    datas = [_structured(40, 50_000), _copies(30_000, 45), _copies(200_000, 46), _runs(300_000, 44), data,
             _copies(2 * N, 47)]
    members = [_compress(datas[0]), _member9(datas[1]), _member9(datas[2]), _zlib_member(datas[3]), spliced,
               _member9(datas[5])]
    assert len(pv2.dnp.split_members(np.frombuffer(members[0], np.uint8))) == 1
    return b"".join(members), [len(d) for d in datas]


@pytest.fixture(scope="module")
def reference():
    """The stream, its ISIZEs, and the reference's output and stats on "on"."""
    gz, isizes = _pass_stream()
    want = v2.gzip_decompress_tpu_v2(gz, device_resolve="on")
    return gz, isizes, want, {k: v2.LAST_DECODE_STATS[k] for k in STAT_KEYS}


@pytest.mark.parametrize("tiles", [1, 2])
def test_passes_match_reference(monkeypatch, reference, tiles):
    """Under a bound of ``tiles`` tiles every member above it resolves in
    passes on the device route: the reference's bytes and routing counts,
    no K7 launch, at least 2 passes for each member above the bound, and
    no tile split of more than a pass's tiles."""
    gz, isizes, want, want_stats = reference
    _lower(monkeypatch, tiles)
    seen = _split_spy(monkeypatch)
    got = pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on")
    stats = pv2.LAST_DECODE_STATS
    assert got == want == pygzip.decompress(gz)
    assert {k: stats[k] for k in STAT_KEYS} == want_stats
    assert stats["host_resolved"] == 0 and stats["device_resolved"] == len(isizes)
    assert stats["launches"]["compact_any"] == 0
    B = tiles * N
    big = [n for n in isizes if n > B]
    assert len(big) >= 3 and all(-(-n // B) >= 2 for n in big)
    assert stats["passes"] == sum(-(-n // B) for n in big)
    assert seen and max(T for T, _t in seen) <= tiles


def test_passes_over_a_cpu_mesh(monkeypatch, reference):
    """The same stream over a 4-shard CPU mesh: the one-device bytes and
    stats."""
    gz, _isizes, want, _want_stats = reference
    _lower(monkeypatch, 1)
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on") == want
    single = {k: v for k, v in pv2.LAST_DECODE_STATS.items() if k != "launches"}
    mesh = make_codec_mesh(devices=[CPU] * 4)
    assert pv2.gzip_decompress_v2(gz, mesh=mesh, device_resolve="on") == want
    assert {k: v for k, v in pv2.LAST_DECODE_STATS.items() if k != "launches"} == single
    assert single["passes"] > 0 and single["host_resolved"] == 0


def _bad_distance_big() -> bytes:
    """The bad-distance member with 100 KB more after it, so that it takes
    the pass route under a bound of one tile: a distance before the start
    can only come in the first 32 KiB of output, so its error position
    lies in the first pass."""
    d = _copies(32768, 51)
    payload = _raw9(b"head " * 60, flush=zlib.Z_SYNC_FLUSH)
    payload += _raw9(d[-20000:] + _copies(30000, 52), zdict=d, flush=zlib.Z_SYNC_FLUSH) + _raw9(_copies(100_000, 53))
    return _td_member(payload, 150_300, 0)


@pytest.mark.parametrize("where", ["late_block", "truncated", "bad_distance", "crc", "isize"])
def test_late_pass_corruption_same_reason(monkeypatch, where):
    """The corruptions of the device route's test, in the 200 KB member
    that takes 4 passes of one tile here (a flipped byte or a cut payload
    in its last block, a flipped CRC or ISIZE), and a distance before the
    start in a member above the bound: the reference's Reason."""
    gz = {"bad_distance": _bad_distance_big}.get(where, lambda: _corrupt(where))()
    want = _reason(lambda b: v2.gzip_decompress_tpu_v2(b, device_resolve="on"), gz)
    _lower(monkeypatch, 1)
    got = _reason(lambda b: pv2.gzip_decompress_v2(b, device=CPU, device_resolve="on"), gz)
    assert got is not None and got == want
    if where == "crc":  # resolved in all 4 passes: the CRC folded across them fails
        assert pv2.LAST_DECODE_STATS["passes"] == 4


# ---------------------------------------------------------------------------
# Hand-made lanes: every kind of seam
# ---------------------------------------------------------------------------


def _out(tokens) -> int:
    t = np.asarray(tokens, np.int64)
    return int(np.where((t & MATCH) != 0, (t >> 16) & 0x3FF, 1).sum())


def _exact(total: int, seed: int) -> list[int]:
    """Random tokens, then literals up to exactly ``total`` bytes."""
    toks = _long_member(seed, total - 300)
    return toks + [k & 0xFF for k in range(total - _out(toks))]


def _stored_across() -> list:
    """Huffman tokens up to 700 bytes before the first seam, a stored
    block's 3000 literal bytes across it (a NumPy segment), then matches
    that reach back into it."""
    head = _exact(N - 700, 21)
    stored = np.random.default_rng(22).integers(0, 256, 3000).astype(np.int32)
    tail = [MATCH | 258 << 16 | 2999] * 300 + _long_member(23, 40000)
    return [np.array(head, np.int32), stored, np.array(tail, np.int32)]


LANES = {
    # a 258-run straddling every seam: each pass after the first opens with its second half
    "mid_match": lambda: np.array_split(np.array(_straddlers(4), np.int32), 3),
    # a run ending exactly on the first seam (no head), a straddler on the second
    "on_token_boundary": lambda: [np.array(_run_on_seam(), np.int32)],
    # the lane ends on a seam: 3 full tiles
    "isize_multiple": lambda: np.array_split(np.array(_exact(3 * N, 24), np.int32), 5),
    "stored_across": _stored_across,
    # one segment of 2.5 tiles of literals: the seams' sums run over chunks of B tokens
    "one_big_segment": lambda: [np.random.default_rng(25).integers(0, 256, 5 * N // 2).astype(np.int32)],
}


def _lane_state(segments: list) -> pv2.LaneState:
    """A finished lane: NumPy segments as a stored block leaves them, every
    other segment a tensor as a Huffman block on the device route does."""
    st = pv2.LaneState(b"", device_cap=1 << 30)
    for k, seg in enumerate(segments):
        st.tokens.append(seg if k % 2 else torch.from_numpy(seg))
        st.sizes.append(_out(seg))
    st.out_total = sum(st.sizes)
    return st


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("case", sorted(LANES))
def test_pass_seams(monkeypatch, case, tiles):
    """Each lane resolves in ceil(total / B) passes to the reference's
    serial resolve with zlib's CRC folded across the passes, and the passes'
    tiles, one after another, are the reference's split of the whole lane."""
    segments = LANES[case]()
    whole = np.concatenate(segments)
    _lower(monkeypatch, tiles)
    seen = _split_spy(monkeypatch)
    st = _lane_state(segments)
    stats: dict = {}
    total = st.out_total
    (got,) = pv2._decode_chained_device([st], [total], True, pv2.WaveRunner.on(CPU), stats)
    want = rp.resolve_reference(whole.astype(np.int64))
    assert got == (want, zlib.crc32(want))
    B = tiles * N
    assert stats["passes"] == -(-total // B) >= 2
    assert stats["chained_tiles"] == -(-total // N)
    tiles_all = torch.cat([t[0] for _T, t in seen]).numpy()
    np.testing.assert_array_equal(tiles_all, rp.split_tokens_tiles(whole))
    assert st.tokens == [] and st.sizes == []


def test_crc_folded_across_passes(monkeypatch):
    """Lanes one byte short of, exactly at and one byte past 3 passes of
    one tile: the CRC folded from every tile's register equals zlib's."""
    _lower(monkeypatch, 1)
    for total in (3 * N - 1, 3 * N, 3 * N + 1):
        data = np.random.default_rng(total).integers(0, 256, total).astype(np.int32)
        st = _lane_state(np.array_split(data, 4))
        (got,) = pv2._decode_chained_device([st], [total], True, pv2.WaveRunner.on(CPU), {})
        assert got == (data.astype(np.uint8).tobytes(), zlib.crc32(data.astype(np.uint8).tobytes()))


def test_error_position_in_a_late_pass_hands_back(monkeypatch):
    """A lane whose only error position (a distance past 32 KiB) lies in
    pass 2 of one-tile passes goes back to the host route with its
    segments kept, as the reference's resolve_big_streams hands it back;
    a clean lane beside it resolves with its CRC."""
    _lower(monkeypatch, 1)
    clean = _long_member(61, 2 * N + 3000)
    bad = _long_member(62, 2 * N + 500) + [MATCH | 9 << 16 | 0x8000, 65] + _long_member(63, 2 * N)
    states = [_lane_state(np.array_split(np.array(t, np.int32), 3)) for t in (clean, bad)]
    kept = list(states[1].tokens)
    stats: dict = {}
    outs = pv2._decode_chained_device(states, [st.out_total for st in states], True, pv2.WaveRunner.on(CPU), stats)
    want = rp.resolve_reference(np.array(clean, np.int64))
    assert outs[0] == (want, zlib.crc32(want)) and outs[1] is None
    assert stats["passes"] == 3 + 3  # the bad lane stops in its third pass of 5
    assert states[0].tokens == [] and len(states[1].tokens) == 3
    assert all(a is b for a, b in zip(states[1].tokens, kept))
    resid = rp.resolve_big_streams([np.array(bad, np.int32)], interpret=True)[1][0]
    assert resid > 0
    # the host route then resolves the kept segments, as for any handed-back lane
    assert pv2._resolve_lane(states[1], None) == rp.resolve_reference(np.array(bad, np.int64))
