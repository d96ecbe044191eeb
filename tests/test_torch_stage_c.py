"""Stage C (``decode_kernels.stage_c``, ``csrc/stage_c.cu``): a NumPy
mirror of the kernel's segmented composition held against the port's plain
version ``decode_kernels.stage_c_plain``, and the plain version against the
JAX package's ``decode_jax_v2.stage_c_entries``.

The kernel cuts each lane's tiles into segments of
``decode_kernels.stage_c_segment(L, NT)`` tiles, one block each. In a
block, the segment's n tiles form at most MAX_CHUNKS chunks of C =
ceil(n / MAX_CHUNKS) neighbouring tiles, G = 4, 8 or 16 threads a chunk,
each taking 48 / G of its entries through the chunk's tiles; a
Hillis-Steele scan over the chunk maps gives each chunk's inclusive map
(the last one the segment's),
warp 0 finds the state entering the segment by a decoupled look-back over
the lane's earlier segments (each publishes its map, then its exit state;
the warp reads LOOK flags a round, takes the nearest exit state and applies
the maps in between, and folds a round with no exit state into one map),
and a thread a chunk replays it from the chunk before's inclusive map
applied to that state. The mirror repeats those steps with the same
segment, chunk, thread and round counts, on every lane at once, and runs
the look-backs in any order the kernel allows.

The plain version's contract holds for any value: a state of 127 or more
passes through, one below 48 is looked up (a negative entry0 as 0), one of
48..126 becomes 255, and the outputs are the low byte. The reference
documents maps of [0, 48) plus the sentinels 127 and 255 and entry0 in [0,
48): outside that its two branches (NT a multiple of 128 or not) answer
differently, so it is compared there only. The pipeline is integer-only,
so every comparison is exact."""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax_v2 as v2

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_v2 as pv2

E = dk.E_WIN
EOB, ERR = dk.SENT_EOB, dk.SENT_ERR
THREADS = dk.STAGE_C_THREADS  # threads a block of csrc/stage_c.cu
MAX_CHUNKS = 32  # chunks a segment at most
LOOK = 32  # predecessors a look-back round (the lanes of warp 0)
AGG, PREFIX = 1, 2  # a segment's status: its map published; its exit state


def apply(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's apply per lane: m (L, 48) maps, v (L,) or (L, n) int64
    states."""
    vv = v.reshape(v.shape[0], -1)
    got = np.take_along_axis(m, np.clip(vv, 0, E - 1), axis=1).astype(np.int64)
    return np.where(vv >= EOB, vv, np.where(vv < E, got, ERR)).reshape(v.shape)


def apply1(m: np.ndarray, v: int) -> int:
    """apply() of one map (48,) to one state."""
    return v if v >= EOB else int(m[max(v, 0)]) if v < E else ERR


def chunking(n: int, whole: int | None = None) -> tuple:
    """A segment of n tiles in the kernel: (C tiles a chunk, chunks, G
    threads a chunk, entries a thread). G is the launch's, from a whole
    segment of ``whole`` tiles (default n; a lane's last segment may be
    shorter)."""
    C = -(-n // MAX_CHUNKS)
    nchunks = -(-n // C)
    wc = -(-(whole or n) // -(-(whole or n) // MAX_CHUNKS))
    G = 16 if wc <= THREADS // 16 else 8 if wc <= THREADS // 8 else 4
    return C, nchunks, G, E // G


def compose_segment(seg_maps: np.ndarray, whole: int):
    """Steps (2) and (3) of a block on (L, n, 48) int64 maps of a launch
    whose whole segments have ``whole`` tiles: C, the chunk count, and
    each chunk's inclusive map (L, chunks, 48)."""
    n = seg_maps.shape[1]
    C, nchunks, G, per = chunking(n, whole)
    assert nchunks * G <= THREADS
    chunk = np.zeros((seg_maps.shape[0], nchunks, E), np.int64)
    # Thread (c, g) takes entries g, g + G, ... of chunk c through its tiles.
    for c, g in itertools.product(range(nchunks), range(G)):
        e = g + G * np.arange(per)
        v = seg_maps[:, c * C][:, e]
        for t in range(c * C + 1, min(c * C + C, n)):
            v = apply(seg_maps[:, t], v)
        chunk[:, c, e] = v
    # Hillis-Steele: in the round of distance d, chunk c >= d takes chunk
    # c - d's map through its own, an entry a lookup.
    d = 1
    while d < nchunks:
        nxt = chunk.copy()
        for c in range(d, nchunks):
            nxt[:, c] = apply(chunk[:, c], chunk[:, c - d])
        chunk = nxt
        d *= 2
    return C, nchunks, chunk


def look_back(status: list, pub: list, seg: int) -> int:
    """Warp 0's look-back for segment seg >= 1 of one lane: status[j] is
    None (the kernel spins), (AGG, None) or (PREFIX, exit state); pub[j]
    segment j's map (48,)."""
    acc = None  # the maps of the rounds walked, composed, oldest first
    top = seg - 1
    while True:
        flags = []
        for lid in range(LOOK):
            j = top - lid
            st = (PREFIX, None) if j < 0 else status[j]
            assert st is not None, "the mirror's order let a look-back read an unpublished segment"
            flags.append(st)
        prefix = [lid for lid in range(LOOK) if flags[lid][0] == PREFIX]
        stop = prefix[0] if prefix else LOOK
        win = [pub[top - lid] for lid in range(stop)]
        if prefix:
            s = flags[stop][1]
            for i in range(stop - 1, -1, -1):
                s = apply1(win[i], s)
            return s if acc is None else apply1(acc, s)
        # No exit state in this round: lanes e and e + 32 fold its maps in front of acc.
        y = np.arange(E, dtype=np.int64)
        for i in range(LOOK - 1, -1, -1):
            y = apply(np.broadcast_to(win[i], (E, E)), y)
        acc = y if acc is None else apply(np.broadcast_to(acc, (E, E)), y)
        top -= LOOK


def mirror(maps: np.ndarray, entry0: np.ndarray, seg_len: int | None = None, order=None):
    """The kernel's method on (L, NT, 48) uint8 maps and (L,) int32 entry0
    -> (entries uint8, final uint8, entries int32). seg_len defaults to the
    wrapper's; order(nseg) gives the order in which segments 1.. run their
    look-backs (segment 0 publishes its exit state first; the kernel's
    blocks do so in any order), ascending by default."""
    L, NT, _E = maps.shape
    seg_len = dk.stage_c_segment(L, NT) if seg_len is None else seg_len
    nseg = -(-NT // seg_len)
    m64 = maps.astype(np.int64)
    segs = []
    for seg in range(nseg):
        t_begin = seg * seg_len
        seg_maps = m64[:, t_begin : t_begin + seg_len]
        segs.append((t_begin, seg_maps, *compose_segment(seg_maps, min(seg_len, NT))))
    ent = np.zeros((L, NT), np.int64)
    final = np.zeros(L, np.int64)
    for lane in range(L):
        # Every segment past the first publishes its map before it looks back.
        status = [None] + [(AGG, None)] * (nseg - 1)
        pub = [seg[4][lane, -1] for seg in segs]
        entry = {}
        rest = list(range(1, nseg)) if order is None else list(order(nseg))
        assert sorted(rest) == list(range(1, nseg))
        for seg in [0] + rest:
            s = int(entry0[lane]) if seg == 0 else look_back(status, pub, seg)
            entry[seg] = s
            out = apply1(pub[seg], s)
            status[seg] = (PREFIX, out)
            if seg == nseg - 1:
                final[lane] = out
        for seg, (t_begin, seg_maps, C, nchunks, incl) in enumerate(segs):
            n = seg_maps.shape[1]
            for k in range(nchunks):
                s = entry[seg] if k == 0 else apply1(incl[lane, k - 1], entry[seg])
                for t in range(k * C, min(k * C + C, n)):
                    ent[lane, t_begin + t] = s
                    s = apply1(seg_maps[lane, t], s)
    low = ent & 0xFF
    return low.astype(np.uint8), (final & 0xFF).astype(np.uint8), low.astype(np.int32)


def edge_maps(rng, L: int, NT: int) -> np.ndarray:
    """Maps mostly in [0, 48), with 127 and 255 and the values outside the
    domain, 48..126 and 128..254, mixed in."""
    maps = rng.integers(0, E, (L, NT, E)).astype(np.uint8)
    u = rng.random(maps.shape)
    maps[u < 0.004] = EOB
    maps[(u >= 0.004) & (u < 0.007)] = ERR
    out = (u >= 0.007) & (u < 0.009)
    maps[out] = rng.integers(E, EOB, int(out.sum()))
    high = (u >= 0.009) & (u < 0.011)
    maps[high] = rng.integers(EOB + 1, ERR, int(high.sum()))
    return maps


def entries_all_bytes(L: int) -> np.ndarray:
    """entry0 over every byte value, then -1 and 1000 (int32 beyond a byte)."""
    return np.concatenate([np.arange(256), [-1, 1000]])[:L].astype(np.int32)


def story_maps(rng, NT: int, seg_len: int) -> np.ndarray:
    """(3, NT, 48) maps of three lanes, read from entry0 5: the state turns
    EOB inside a segment (lane 0) or error inside a segment (lane 1), or
    leaves the first segment in a state of 48..126 (lane 2: every entry of
    the first segment's last map is 100)."""
    maps = rng.integers(0, E, (3, NT, E)).astype(np.uint8)
    inside = min(NT - 1, seg_len // 2 + 1)
    maps[0, inside] = EOB
    maps[1, inside] = ERR
    maps[2, min(NT, seg_len) - 1] = 100
    return maps


def _check_plain(maps: np.ndarray, entry0: np.ndarray, **kw) -> None:
    want = mirror(maps, entry0, **kw)
    got = dk.stage_c_plain(torch.from_numpy(maps), torch.from_numpy(entry0))
    for g, w in zip(got, want[:2]):
        np.testing.assert_array_equal(g.numpy(), w)
    wrapped = dk.stage_c(torch.from_numpy(maps), torch.from_numpy(entry0))
    assert [t.dtype for t in wrapped] == [torch.uint8, torch.uint8, torch.int32]
    for g, w in zip(wrapped, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("NT", [1, 3, 128])
def test_mirror_every_entry_byte(NT):
    """Every entry0 byte value (and -1, 1000) on maps with every kind of
    value; NT of one tile, a partial chunk and a whole window of chunks
    of one."""
    rng = np.random.default_rng(NT)
    L = 258
    _check_plain(edge_maps(rng, L, NT), entries_all_bytes(L))


@pytest.mark.parametrize("NT", [384, 4224])
def test_mirror_windows(NT):
    """Four lanes of the main path's widest wave (384 tiles: 24 segments of
    16, a chunk a tile, 8 threads a chunk) and of the largest tile count
    (4224 = P 270336 / 64 bytes: 17 segments of 256, 32 chunks of 8
    tiles, 4 threads a chunk)."""
    rng = np.random.default_rng(NT)
    L = 4
    entry0 = np.array([0, 5, 47, EOB], np.int32)
    _check_plain(edge_maps(rng, L, NT), entry0)


def test_chunking():
    """A segment's chunks: at most MAX_CHUNKS of C tiles, G threads a
    chunk within the block (G the launch's, from a whole segment), G
    dividing the 48 entries."""
    assert [chunking(n) for n in (1, 8, 9, 16, 17, 32, 33, 384, 512)] == [
        (1, 1, 16, 3), (1, 8, 16, 3), (1, 9, 8, 6), (1, 16, 8, 6), (1, 17, 4, 12), (1, 32, 4, 12),
        (2, 17, 4, 12), (12, 32, 4, 12), (16, 32, 4, 12)]
    assert [chunking(n, 512)[2] for n in (1, 8, 33)] == [4, 4, 4]
    for whole in range(1, dk.STAGE_C_MAX_SEGMENT + 1):
        for n in {1, whole // 2 + 1, whole - 1, whole} - {0}:
            C, nchunks, G, per = chunking(n, whole)
            assert nchunks <= MAX_CHUNKS and nchunks * G <= THREADS and G * per == E
            assert (nchunks - 1) * C < n <= nchunks * C


def test_segment_lengths():
    """The wrapper's segment length: a power of two from 16 to 512 that
    leaves a lane at most STAGE_C_LOOK segments and the wave at most
    STAGE_C_BLOCKS blocks while it can grow, never more than NT; the main
    path's waves (4 x 128, 256 x 128, 256 x 256, 256 x 384, 4 x 1024), the
    continuous member's (4 x 1152) and one-lane waves."""
    seg = dk.stage_c_segment
    assert [seg(4, 128), seg(256, 128), seg(256, 256), seg(256, 384), seg(4, 1024), seg(4, 1152)] == [
        16, 128, 256, 384, 64, 64]
    assert [seg(1, 1), seg(1, 15), seg(1, 384), seg(1, 513), seg(1, 4224), seg(8, 4224), seg(258, 3)] == [
        1, 15, 16, 32, 256, 512, 3]
    for L, NT in itertools.product((1, 2, 4, 7, 64, 256, 258, 1024), (1, 2, 17, 128, 384, 511, 1024, 4224)):
        s = seg(L, NT)
        nseg = -(-NT // s)
        assert 1 <= s <= min(NT, dk.STAGE_C_MAX_SEGMENT)
        assert s == NT or s in (16, 32, 64, 128, 256, 512)
        assert nseg <= dk.STAGE_C_LOOK
        assert L * nseg <= dk.STAGE_C_BLOCKS or s == dk.STAGE_C_MAX_SEGMENT or s == NT
        assert s == min(16, NT) or L * -(-NT // (s // 2)) > dk.STAGE_C_BLOCKS or -(-NT // (s // 2)) > dk.STAGE_C_LOOK


@pytest.mark.parametrize("NT", [1, 2, 15, 16, 17, 33, 511, 512, 513, 4224])
def test_mirror_one_lane(NT):
    """One-lane waves: NT of 1 and 2, the smallest segment length (16)
    - 1, itself and + 1, a last segment of one tile (33: 3 segments of
    16), 511 and 512 (32 segments of 16), 513 (17 of 32, the last of one
    tile) and 4224 (17 of 256); maps whose state turns EOB or error inside
    a segment and one whose first segment ends in a state of 48..126."""
    rng = np.random.default_rng(NT + 1)
    maps = np.concatenate([edge_maps(rng, 1, NT), story_maps(rng, NT, dk.stage_c_segment(1, NT))])
    for lane in range(4):
        _check_plain(maps[lane : lane + 1], np.array([[1000, 5, 5, 5][lane]], np.int32))


@pytest.mark.parametrize("seg_len,NT", [(1, 1), (1, 2), (1, 40), (1, 100), (2, 65), (511, 1023), (512, 1025),
                                        (513 - 1, 513), (129, 300), (127, 254)])
def test_mirror_forced_segments(seg_len, NT):
    """The mirror at segment lengths the wrapper does not pick (the kernel
    takes any from 1 to 512): segments of one tile (one chunk of 16
    threads each, the look-back over rounds of one-tile maps), of 2, and
    around 128 and 512 tiles (chunks of 4, 5 and 16 tiles, 4 threads a
    chunk, a shorter last chunk)."""
    rng = np.random.default_rng(seg_len * 7 + NT)
    L = 3
    maps = edge_maps(rng, L, NT)
    maps[2] = story_maps(rng, NT, seg_len)[2]
    _check_plain(maps, np.array([0, 47, 5], np.int32), seg_len=seg_len)


def _orders():
    """Look-back orders: every one of four segments, then reversed and
    shuffled ones."""
    yield from ((f"perm{''.join(map(str, p))}", 4, lambda n, p=p: p) for p in itertools.permutations((1, 2, 3)))
    yield "reversed", 264, lambda n: range(n - 1, 0, -1)
    yield "shuffled", 264, lambda n: np.random.default_rng(n).permutation(np.arange(1, n))
    yield "odd first", 264, lambda n: [*range(n - 1 if n % 2 == 0 else n - 2, 0, -2), *range(2, n, 2)]


@pytest.mark.parametrize("label,nseg,order", list(_orders()), ids=[o[0] for o in _orders()])
def test_mirror_any_lookback_order(label, nseg, order):
    """The segments finish in any order the look-back allows (segment 0
    first, since every other waits on an exit state): every order of four
    segments, and 264 segments of 16 tiles reversed (each look-back walks
    back to segment 0, folding rounds with no exit state), shuffled and
    odd segments first. The entries and final states are those of the
    ascending order and of the plain version."""
    rng = np.random.default_rng(nseg)
    NT = 16 * nseg
    maps = np.concatenate([edge_maps(rng, 2, NT), story_maps(rng, NT, 16)])
    entry0 = np.array([0, 47, 5, 5, 5], np.int32)
    want = dk.stage_c_plain(torch.from_numpy(maps), torch.from_numpy(entry0))
    base = mirror(maps, entry0, seg_len=16)
    got = mirror(maps, entry0, seg_len=16, order=order)
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g, b)
    for g, w in zip(want, got[:2]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_mirror_dense_values():
    """Maps that are mostly sentinels and values outside the domain, and
    maps of one fixed point (every chunk map the identity on it)."""
    rng = np.random.default_rng(3)
    L, NT = 6, 700
    maps = rng.choice(np.array([0, 1, 47, 48, 100, 126, EOB, 128, 200, 254, ERR], np.uint8), (L, NT, E))
    maps[4] = 7
    maps[5] = np.arange(E, dtype=np.uint8)
    _check_plain(maps, np.array([0, 1, 47, 48, EOB, 7], np.int32))


def test_plain_matches_reference_every_entry():
    """The plain version against the JAX package on maps of [0, 48) with
    the sentinels, from every entry0 in [0, 48) (the reference's byte-wise
    branch; its packed branch, NT a multiple of 128, is held in
    test_torch_decode_kernels.py)."""
    rng = np.random.default_rng(5)
    L, NT = E, 3
    maps = rng.integers(0, E, (L, NT, E)).astype(np.uint8)
    maps[rng.random(maps.shape) < 0.02] = EOB
    maps[rng.random(maps.shape) < 0.02] = ERR
    entry0 = np.arange(E, dtype=np.int32)
    got_e, got_f = pv2.stage_c_entries(torch.from_numpy(maps), torch.from_numpy(entry0))
    want_e, want_f = v2.stage_c_entries(jnp.asarray(maps), jnp.asarray(entry0).astype(jnp.uint8))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_plain_matches_reference_outside_domain():
    """Where NT is not a multiple of 128 the reference composes byte by
    byte, and there it agrees with the plain version on map values of
    48..126 and 128..254 too."""
    rng = np.random.default_rng(11)
    L, NT = 4, 45
    maps = edge_maps(rng, L, NT)
    entry0 = np.array([0, 3, 30, 47], np.int32)
    got_e, got_f = pv2.stage_c_entries(torch.from_numpy(maps), torch.from_numpy(entry0))
    want_e, want_f = v2.stage_c_entries(jnp.asarray(maps), jnp.asarray(entry0).astype(jnp.uint8))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_wrapper_checks():
    """The wrapper takes (L, NT, 48) uint8 maps and an (L,) int32 entry0."""
    maps = torch.zeros((2, 4, E), dtype=torch.uint8)
    with pytest.raises(ValueError):
        dk.stage_c(maps, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        dk.stage_c(maps[:, :, :40].contiguous(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.stage_c(maps, torch.zeros(3, dtype=torch.int32))
