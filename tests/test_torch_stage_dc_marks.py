"""A mirror of K3's algorithm (csrc/stage_dc.cu, stage DC), written here in
NumPy. A lane's tiles are cut into strips of TB neighbouring tiles (32
where that gives the wave 256 blocks, else 8; the last strip partial where
NT is not a multiple of TB); a strip's deltas are staged
once as first hops (p + cursor_adv(d) inside the tile, else a terminal)
with each position's class (valid d < 127, EOB, error, none), 2 bytes a
position. The chain from each tile's entry (dead outside [0, 48)) is then
reached through the staged hops, and every reached position, terminal ones
included, is listed with its class over the hop table in place. A warp per
tile ranks the valid listed positions by 32-wide ballots in list order,
writes the first k1 tokens and the -1 padding, and sums the summary rows
wrapping like uint32.

Two ways to reach the chain are mirrored: the serial walk the kernel
runs (one thread per tile through the staged hops), and the pointer
jumping with marks of K9 (one warp per tile: in round r every marked
position whose 2^r-th successor is not terminal marks it, then the hops
jump; a tile stops once no marked position has a live hop), which the
kernel's design was measured against. Both give the same lists.

The mirror is held equal to the port's plain version
``decode_kernels.stage_dc_plain`` and to the JAX package's Pallas kernel
in interpret mode: on a random wave at every k1 and strip width, on a real
wave (stage A of profile streams with a garbage lane), on the edge deltas
of ``chip_smoke.k3_edge_inputs`` (stops, the int32 limits, dense
sentinels; entries 0, 47, 48, 255) and with entries -1, 0, 47, 48 and 255,
and on a tile whose 512 positions are 1-bit deltas (all nine jumping
rounds, a 512-link walk); and on partial strips (NT of 3, 45 and 100).
The Pallas kernel takes blocks of 128 tiles: other tile counts are padded
with dead tiles and its first NT tiles compared. The pipeline is
integer-only, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate.codec.profile import profile_compress_host

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import wave_prep as wp

W_P, E_WIN = dk.W_P, dk.E_WIN
EOB, ERR = wp.SENT_EOB, wp.SENT_ERR
THREADS = 256  # threads per block
H_TERM, H_POS, CLS_SHIFT = 0x8000, 0x1FF, 12
CLS_VALID, CLS_EOB, CLS_ERR = 1, 2, 3
ROUNDS = 9  # ceil(log2(512))
K1S = sorted(set(wp.K1_CHOICES) | {W_P})
M32 = (1 << 32) - 1


def strip_width(L: int, NT: int) -> int:
    """Strips of 32 tiles where the wave has 256 blocks of them, else of 8."""
    return 32 if L * NT >= 32 * 256 else 8


def hop_words(tb: int) -> int:
    """Words of one tile's staged hop table: 256 plus 32 / TB of padding."""
    return W_P // 2 + 32 // tb


def staging_banks(tb: int) -> np.ndarray:
    """(instructions, 32) shared-memory bank of each lane's staging store:
    thread i of the block packs row pair pp = idx / TB of tile idx % TB,
    idx = i + 256 k, into word tile * hop_words + pp."""
    idx = np.arange(tb * W_P // 2).reshape(-1, 32)
    return (idx % tb * hop_words(tb) + idx // tb) % 32


def hop_codes(d: np.ndarray) -> np.ndarray:
    """Deltas (..., 512) -> the staged hop codes (uint16 values): the next
    position or H_TERM, with the class in bits 12-13."""
    d = d.astype(np.int64)
    p = np.arange(W_P)
    a = np.where(d == EOB, 4096, np.where(d == ERR, 8192, d))
    nxt = np.where((a <= 0) | (a >= W_P - p), H_TERM, p + a)
    cls = np.where(d < EOB, CLS_VALID, np.where(d == EOB, CLS_EOB, np.where(d == ERR, CLS_ERR, 0)))
    return nxt | cls << CLS_SHIFT


def reach_walk(table: np.ndarray, entries: np.ndarray) -> np.ndarray:
    """A thread per tile walks from its entry through the hop codes
    (tiles, 512), listing each reached position | class << 12 over the
    table in place; returns the list lengths. A list entry is written at
    index n <= its position, and every later link lies past it."""
    T = table.shape[0]
    rows = np.arange(T)
    active = (entries >= 0) & (entries < E_WIN)
    cur = np.where(active, entries, 0).astype(np.int64)
    n = np.zeros(T, np.int64)
    while active.any():
        c = table[rows, cur]
        r = rows[active]
        table[r, n[active]] = (c[active] & (3 << CLS_SHIFT)) | cur[active]
        n += active
        active &= (c & H_TERM) == 0
        cur = np.where(active, c & H_POS, 0)
    return n


def reach_jump(table: np.ndarray, entries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pointer jumping with marks, a warp per tile: lists the marked
    positions in position order over the table; returns (list lengths,
    rounds each tile jumped)."""
    T = table.shape[0]
    rows = np.arange(T)
    v = table & (H_TERM | H_POS)
    cls = (table >> CLS_SHIFT) & 3
    mark = np.zeros((T, W_P), bool)
    ok = (entries >= 0) & (entries < E_WIN)
    mark[rows[ok], entries[ok]] = True
    live = np.ones(T, bool)
    rounds = np.zeros(T, np.int64)
    for _r in range(ROUNDS):
        lead = mark & ((v & H_TERM) == 0)
        live &= lead.any(1)
        lead &= live[:, None]
        ti, pi = np.nonzero(lead)
        mark[ti, v[ti, pi]] = True
        jumped = np.take_along_axis(v, np.where(v & H_TERM, 0, v), axis=1)
        v = np.where(live[:, None] & ((v & H_TERM) == 0), jumped, v)
        rounds += live
    n = mark.sum(1)
    ti, pi = np.nonzero(mark)
    slot = np.cumsum(mark, axis=1)[ti, pi] - 1
    table[ti, slot] = cls[ti, pi] << CLS_SHIFT | pi
    return n, rounds


def emit(lists: np.ndarray, n: np.ndarray, tok: np.ndarray, k1: int) -> tuple[np.ndarray, np.ndarray]:
    """A warp per tile: lists (tiles, 512), tokens (tiles, 512) ->
    (tokens (tiles, k1), sums (tiles, 8) as uint32). Ballots of 32 list
    entries rank the valid ones: rank = count + popc(ballot & lanes below)."""
    T = lists.shape[0]
    rows = np.arange(T)
    j = np.arange(W_P)
    e = np.where(j < n[:, None], lists, 0)
    cls, pos = e >> CLS_SHIFT, e & H_POS
    tv = np.where(cls != 0, tok[rows[:, None], pos], 0).astype(np.int64)
    valid = cls == CLS_VALID
    out = np.full((T, k1 + 1), -1, np.int64)
    count = np.zeros(T, np.int64)
    lanes = np.arange(32, dtype=np.uint64)
    below = (np.uint64(1) << lanes) - np.uint64(1)
    for c in range(W_P // 32):
        v = valid[:, 32 * c : 32 * c + 32]
        bal = (v.astype(np.uint64) << lanes).sum(1, dtype=np.uint64)
        rank = count[:, None] + np.bitwise_count(bal[:, None] & below).astype(np.int64)
        ti, li = np.nonzero(v & (rank < k1))
        out[ti, rank[ti, li]] = tv[ti, 32 * c + li]
        count += np.bitwise_count(bal).astype(np.int64)
    is_eob, is_err = cls == CLS_EOB, cls == CLS_ERR
    size = np.where((tv >= 0) & (tv < 256), 1, (tv >> 16) & 0x3FF)
    sums = np.stack(
        [
            count,
            (is_eob * pos).sum(1),
            (is_eob * tv).sum(1),
            (is_err * tv).sum(1),
            (valid * size).sum(1),
            is_eob.sum(1),
            is_err.sum(1),
            (count > k1).astype(np.int64),
        ],
        axis=1,
    )
    return out[:, :k1], sums & M32


def mirror_stage_dc(delta, token, entries, k1, *, tb=None, reach="walk"):
    """K3's strips, staging, reach and emit: (tokens (L, NT, k1) int32,
    summary (L, 8, NT) int32, the strip width, rounds per tile for the
    jumping reach)."""
    L, _W, NT = delta.shape
    tb = tb or strip_width(L, NT)
    tokens = np.zeros((L, NT, k1), np.int32)
    summ = np.zeros((L, 8, NT), np.int64)
    rounds = np.zeros((L, NT), np.int64)
    covered = np.zeros((L, NT), np.int64)
    for l in range(L):
        for t0 in range(0, NT, tb):
            nt = min(tb, NT - t0)
            covered[l, t0 : t0 + nt] += 1
            table = np.full((tb, W_P), H_TERM, np.int64)  # tiles past NT stay terminal
            table[:nt] = hop_codes(delta[l, :, t0 : t0 + nt].T)
            e = np.full(tb, -1, np.int64)
            e[:nt] = entries[l, t0 : t0 + nt]
            if reach == "walk":
                n = reach_walk(table, e)
            else:
                n, r = reach_jump(table, e)
                rounds[l, t0 : t0 + nt] = r[:nt]
            tok, sums = emit(table[:nt], n[:nt], token[l, :, t0 : t0 + nt].T, k1)
            tokens[l, t0 : t0 + nt] = tok
            summ[l, :, t0 : t0 + nt] = sums.T
    assert (covered == 1).all()
    return tokens, summ.astype(np.uint32).view(np.int32), tb, rounds


def _plain(delta, token, entries, k1):
    t, s = dk.stage_dc_plain(torch.from_numpy(delta), torch.from_numpy(token), torch.from_numpy(entries), k1)
    return t.numpy(), s.numpy()


def _pallas(delta, token, entries, k1):
    """The Pallas kernel in interpret mode; it takes blocks of 128 tiles, so
    NT is padded up to one (with dead tiles) and the first NT returned."""
    NT = delta.shape[2]
    pad = -NT % 128
    if pad:
        delta = np.pad(delta, ((0, 0), (0, 0), (0, pad)), constant_values=1)
        token = np.pad(token, ((0, 0), (0, 0), (0, pad)))
        entries = np.pad(entries, ((0, 0), (0, pad)), constant_values=E_WIN)
    t, s = dp.stage_dc_pallas(jnp.asarray(delta), jnp.asarray(token), jnp.asarray(entries), k1=k1,
                              interpret=True)
    return np.asarray(t)[:, :NT], np.asarray(s)[..., :NT]


def _check(delta, token, entries, k1, *, pallas=True, tb=None):
    want = _plain(delta, token, entries, k1)
    got_t, got_s, used_tb, _r = mirror_stage_dc(delta, token, entries, k1, tb=tb)
    np.testing.assert_array_equal(got_t, want[0])
    np.testing.assert_array_equal(got_s, want[1])
    jt, js, _tb, _r = mirror_stage_dc(delta, token, entries, k1, tb=tb, reach="jump")
    np.testing.assert_array_equal(jt, got_t)
    np.testing.assert_array_equal(js, got_s)
    if pallas:
        pt, ps = _pallas(delta, token, entries, k1)
        np.testing.assert_array_equal(got_t, pt)
        np.testing.assert_array_equal(got_s, ps)
    return used_tb


def _random_wave(seed: int = 7, L: int = 2, NT: int = 128):
    """Random deltas 1..48 with EOB / error sentinels and random literal /
    match tokens, as in test_torch_decode_kernels; entries in [0, 48) with
    dead tiles, and a tile of 512 one-bit literals from entry 0."""
    rng = np.random.default_rng(seed)
    B = W_P * NT
    delta = rng.integers(1, 49, (L, B))
    delta[rng.random((L, B)) < 0.002] = EOB
    delta[rng.random((L, B)) < 0.001] = ERR
    token = rng.integers(0, 256, (L, B))
    m = rng.random((L, B)) < 0.33
    token = np.where(m, (1 << 30) | rng.integers(3, 259, (L, B)) << 16 | rng.integers(0, 1024, (L, B)), token)
    token[delta == EOB] = -(1 + 7)
    token[delta == ERR] = -(100 + 13)

    def tiles(a):
        return np.ascontiguousarray(a.astype(np.int32).reshape(L, NT, W_P).transpose(0, 2, 1))

    delta, token = tiles(delta), tiles(token)
    entries = rng.integers(0, E_WIN, (L, NT)).astype(np.int32)
    entries[:, 1::5] = 127  # dead tiles
    delta[0, :, 2] = 1
    token[0, :, 2] = np.arange(W_P) % 256
    entries[0, 2] = 0
    return delta, token, entries


@pytest.fixture(scope="module")
def random_wave():
    return _random_wave()


@pytest.mark.parametrize("k1", K1S)
def test_mirror_matches_plain_and_pallas_at_every_k1(random_wave, k1):
    delta, token, entries = random_wave
    assert _check(delta, token, entries, k1) == 8
    # the tile of 512 one-bit literals overflows every k1 below 512
    got_t, got_s, _tb, rounds = mirror_stage_dc(delta, token, entries, k1, reach="jump")
    assert got_s[0, wp.ROW_COUNT, 2] == W_P and got_s[0, wp.ROW_OVERFLOW, 2] == int(k1 < W_P)
    assert rounds[0, 2] == ROUNDS


@pytest.mark.parametrize("tb", [8, 32])
def test_every_strip_width_gives_the_same_outputs(random_wave, tb):
    delta, token, entries = random_wave
    _check(delta, token, entries, wp.K1_CHOICES[0], pallas=False, tb=tb)
    # a warp's staging stores hit 32 distinct banks
    banks = staging_banks(tb)
    assert all(len(set(row)) == 32 for row in banks.tolist())


def test_strip_width_of_the_main_path_waves():
    """The decode's five waves: 4 x 128 and 4 x 1024 tiles take strips of 8
    (64 and 512 blocks), the 256-lane waves strips of 32."""
    got = {(L, NT): strip_width(L, NT) for L, NT in ((4, 128), (256, 128), (256, 256), (256, 384), (4, 1024))}
    assert got == {(4, 128): 8, (256, 128): 32, (256, 256): 32, (256, 384): 32, (4, 1024): 8}


def test_mirror_on_a_real_wave():
    """Stage A, B and C (the port's plain versions) of profile streams plus
    a garbage lane give K3's inputs."""
    rng = np.random.default_rng(13)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(40)]
    data = np.concatenate([words[i] for i in rng.integers(0, 40, 30000)]).tobytes()[:100000]
    buf = np.frombuffer(profile_compress_host(data), np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]
    payloads.append(payloads[0][:64] + rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
    w = wp.wave_to_tensors(wp._prep_wave(payloads, 4), torch.device("cpu"))
    delta, token = dk.stage_a(w["grid"], dk.build_meta(w))
    entries, _final = pv2.stage_c_entries(dk.stage_b(delta), w["rem"])
    entries = entries.to(torch.int32)
    k1 = wp._lane_k1(w["_min_tok_bits"])
    _check(delta.numpy(), token.numpy(), entries.numpy(), k1)


@pytest.mark.parametrize("k1", [wp.K1_CHOICES[0], W_P])
def test_mirror_on_the_chip_smoke_edge_inputs(k1):
    """Deltas of 0 and -5 (stop after the position), 60, 2^31 - 1 and
    INT_MIN (leave the tile), dense EOB / error sentinels; entries 0, 47, 48
    and 255 in the first tiles."""
    delta, token, entries = (x.numpy() for x in chip_smoke.k3_edge_inputs())
    _check(delta, token, entries, k1)


def test_entries_outside_the_window():
    """Entries -1, 0, 47, 48 and 255: a negative or >= 48 entry is a dead
    tile, whose tokens are all -1 and whose summary is 0."""
    delta, token, entries = _random_wave(seed=5)
    entries[:, :5] = (-1, 0, 47, 48, 255)
    _check(delta, token, entries, wp.K1_CHOICES[1])
    t, s, _tb, _r = mirror_stage_dc(delta, token, entries, wp.K1_CHOICES[1])
    for tile in (0, 3, 4):
        assert (t[:, tile] == -1).all() and (s[:, :, tile] == 0).all()
    assert (s[:, wp.ROW_COUNT, 1:3] > 0).all()


def test_a_chain_of_512_one_bit_deltas():
    """Every position a 1-bit literal from entry 0: the walk lists all 512
    positions, the jumping reach takes all nine rounds, and the tile
    overflows every k1 below 512."""
    L, NT = 1, 128
    delta = np.ones((L, W_P, NT), np.int32)
    token = (np.arange(W_P, dtype=np.int32) % 256)[None, :, None].repeat(NT, 2)
    entries = np.zeros((L, NT), np.int32)
    for k1 in (wp.K1_CHOICES[-1], W_P):
        _check(delta, token, entries, k1, pallas=k1 == W_P)
        _t, s, _tb, rounds = mirror_stage_dc(delta, token, entries, k1, reach="jump")
        assert (rounds == ROUNDS).all()
        assert (s[0, wp.ROW_COUNT] == W_P).all() and (s[0, wp.ROW_OVERFLOW] == int(k1 < W_P)).all()
    table = hop_codes(delta[0, :, :1].T)
    assert reach_walk(table, np.zeros(1, np.int64))[0] == W_P


@pytest.mark.parametrize("NT", [3, 45, 100])
def test_partial_strips(NT):
    """NT not a multiple of the strip width: held against the plain version
    and the first NT tiles of the Pallas kernel on a 128-tile block."""
    delta, token, entries = _random_wave(seed=NT)
    part = [np.ascontiguousarray(x[..., :NT]) for x in (delta, token, entries)]
    assert NT % _check(*part, wp.K1_CHOICES[0]) != 0
