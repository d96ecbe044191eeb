"""The encoder's symbol-and-histogram pass (``encode._finish_analysis``,
``csrc/finish.cu``): the port's plain version ``_finish_analysis_plain``
against the JAX package's ``encode_jax._finish_analysis`` under
``jax.jit`` on the CPU, and a NumPy mirror of the kernel's method held
against the plain version.

The kernel computes each token's symbols from the closed forms of the RFC
1951 tables with a count of leading zeros (here ``np.frexp``) where the
plain version sums comparisons, and builds the histograms per block of
SEG positions of a row: each warp of the block (the positions of its
threads, 4 consecutive positions a thread a step) counts into its own
sub-histogram, and a block adds each bin's sum over its warps to the
lane's histogram. The mirror repeats that grouping.

Inputs (made with numpy from seeds) reach every run of 3..258, every
distance-symbol base and the value before it (1-5, 256, 257, 24577,
32768 among them), out-of-range runs and distances (clamped), a lane with
no token, a row whose width is not a multiple of 4, and rows of 98304
columns whose first 32768 are history (``valid`` false). The encoder is
integer-only: every comparison is exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import encode_jax as ej

from tpu_deflate_torch.codec import encode as pe

THREADS, WARPS, STEPS = 256, 8, 4  # csrc/finish.cu
SEG = THREADS * 4 * STEPS  # positions a block
LL_BINS, D_BINS = 288, 30
KEYS = ("is_token", "is_match", "litlen_sym", "len_eb", "len_ev", "dist_sym", "dist_eb", "dist_ev",
        "litlen_hist", "dist_hist")
DIST_BASES = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025, 1537, 2049,
              3073, 4097, 6145, 8193, 12289, 16385, 24577)


def floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for x >= 1: 31 - clz(x) in the kernel."""
    return np.frexp(x.astype(np.float64))[1].astype(np.int64) - 1


def length_symbol(run: np.ndarray):
    """The kernel's length_symbol on runs in [3, 258]."""
    r3 = run - 3
    e = np.where(r3 >= 8, floor_log2(np.maximum(r3, 1)) - 2, 0)
    sym = 257 + 4 * e + (r3 >> e)
    ev = run - (((((sym - 257) & 3) + 4) << e) + 3)
    short, top = run <= 10, run >= 258
    return (np.where(short, 254 + run, np.where(top, 285, sym)), np.where(short | top, 0, e),
            np.where(short | top, 0, ev))


def distance_symbol(d: np.ndarray):
    """The kernel's distance_symbol on distances in [1, 32768]."""
    d1 = d - 1
    e = np.where(d1 >= 4, floor_log2(np.maximum(d1, 1)) - 1, 0)
    sym = 2 * e + (d1 >> e)
    ev = d - ((((sym & 1) + 2) << e) + 1)
    near = d1 < 4
    return np.where(near, d1, sym), np.where(near, 0, e), np.where(near, 0, ev)


def mirror(data, use, dist, replay, valid) -> tuple[dict, np.ndarray]:
    """The kernel's method on numpy rows -> (the analysis dict, flags)."""
    L, S = data.shape
    tok = (replay != 0) & (valid != 0)
    mat = tok & (use > 0)
    ls, leb, lev = length_symbol(np.clip(use.astype(np.int64), 3, 258))
    ds, deb, dev = distance_symbol(np.clip(dist.astype(np.int64), 1, 32768))
    out = {
        "is_token": tok, "is_match": mat,
        "litlen_sym": np.where(mat, ls, data).astype(np.int32),
        "len_eb": np.where(mat, leb, 0).astype(np.int32), "len_ev": np.where(mat, lev, 0).astype(np.int32),
        "dist_sym": np.where(mat, ds, 0).astype(np.int32),
        "dist_eb": np.where(mat, deb, 0).astype(np.int32), "dist_ev": np.where(mat, dev, 0).astype(np.int32),
    }
    # Block b = p // SEG of a row; its thread (p % SEG) // 4 % THREADS; the
    # thread's warp owns a sub-histogram of LL_BINS + D_BINS bins.
    p = np.arange(S)
    block, warp = p // SEG, (p % SEG) // 4 % THREADS // 32
    nblocks = -(-S // SEG)
    ll_hist = np.zeros((L, LL_BINS), np.int64)
    d_hist = np.zeros((L, D_BINS), np.int64)
    for lane in range(L):
        sub = np.zeros((nblocks, WARPS, LL_BINS + D_BINS), np.int64)
        t, m = tok[lane], mat[lane]
        np.add.at(sub, (block[t], warp[t], out["litlen_sym"][lane][t]), 1)
        np.add.at(sub, (block[m], warp[m], LL_BINS + out["dist_sym"][lane][m]), 1)
        for b in range(nblocks):
            sums = sub[b].sum(axis=0)
            ll_hist[lane] += sums[:LL_BINS]
            d_hist[lane] += sums[LL_BINS:]
    out["litlen_hist"] = ll_hist.astype(np.int32)
    out["dist_hist"] = d_hist.astype(np.int32)
    return out, (tok.astype(np.int32) | (mat.astype(np.int32) << 1))


def rows(L: int, S: int, seed: int, history: int = 0):
    """(data uint8, use int32, dist int32, replay bool, valid bool) rows:
    lane 0 sweeps every run of 3..258 against every distance-symbol base,
    the value before it and 32768, then out-of-range runs and distances;
    lane 1 has no token; the rest are random parses. ``history`` columns
    at the start of each row are not valid."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (L, S), dtype=np.uint8)
    use = np.where(rng.random((L, S)) < 0.45, 0, rng.integers(3, 259, (L, S))).astype(np.int32)
    dist = rng.integers(1, 32769, (L, S)).astype(np.int32)
    replay = rng.random((L, S)) < 0.6
    valid = np.ones((L, S), bool)
    valid[:, :history] = False
    dists = np.array(sorted({*DIST_BASES, *(b - 1 for b in DIST_BASES[1:]), 32767, 32768}), np.int32)
    runs = np.arange(3, 259, dtype=np.int32)
    n = len(runs) * 2
    c0 = history
    use[0, c0 : c0 + n] = np.tile(runs, 2)
    dist[0, c0 : c0 + n] = np.resize(dists, n)
    replay[0, c0 : c0 + n] = True
    odd = np.array([259, 300, 1000, 2**31 - 1, -5, 0, 7, 258], np.int32)
    odd_d = np.array([40000, 0, -3, 2**31 - 1, 5, 1, 32769, 32768], np.int32)
    use[0, c0 + n : c0 + n + 8] = odd
    dist[0, c0 + n : c0 + n + 8] = odd_d
    replay[0, c0 + n : c0 + n + 8] = True
    if L > 1:
        replay[1] = False
    return data, use, dist, replay, valid


def _reference(data, use, dist, is_token) -> dict:
    fn = jax.jit(ej._finish_analysis)
    out = fn(jnp.asarray(data), jnp.asarray(use), jnp.asarray(dist), jnp.asarray(is_token))
    return {k: np.asarray(v) for k, v in out.items()}


def _plain(data, use, dist, is_token) -> dict:
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (data, use, dist, is_token)]
    return {k: v.numpy() for k, v in pe._finish_analysis_plain(*t).items()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("L, S, history", [(3, 4096, 0), (2, 98304, 32768)])
def test_plain_matches_reference(L, S, history):
    data, use, dist, replay, valid = rows(L, S, seed=S, history=history)
    is_token = replay & valid
    want = _reference(data, use, dist, is_token)
    got = _plain(data, use, dist, is_token)
    assert got.keys() == want.keys() == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["litlen_hist"][1].sum() == 0 and want["dist_hist"][1].sum() == 0
    assert (want["litlen_hist"][0, 257:286] > 0).all() and (want["dist_hist"][0] > 0).all()


@pytest.mark.parametrize("L, S, history", [(3, 4096, 0), (4, 4099, 0), (2, 98304, 32768), (64, 1024, 0)])
def test_mirror_matches_plain(L, S, history):
    """The kernel's method on one SEG, a row of 4099 columns (a partial
    block and a partial last thread), the continuous rows and 64 lanes."""
    data, use, dist, replay, valid = rows(L, S, seed=S + L, history=history)
    want, want_flags = mirror(data, use, dist, replay, valid)
    got = _plain(data, use, dist, replay & valid)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in (data, use, dist, replay, valid)]
    a, flags = pe._finish_analysis(*tensors)
    assert a.keys() == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(a[k].numpy(), want[k], err_msg=k)
    assert flags.dtype == torch.int32
    np.testing.assert_array_equal(flags.numpy(), want_flags)


def test_every_symbol_boundary():
    """Each run and each distance in its whole domain: the kernel's closed
    forms against the plain version's, symbol, extra bits and value."""
    run = torch.arange(3, 259, dtype=torch.int32)
    want = [t.numpy() for t in pe._run_to_symbol(run)]
    for g, w in zip(length_symbol(run.numpy().astype(np.int64)), want):
        np.testing.assert_array_equal(g, w)
    d = torch.arange(1, 32769, dtype=torch.int32)
    want = [t.numpy() for t in pe._dist_to_symbol(d)]
    for g, w in zip(distance_symbol(d.numpy().astype(np.int64)), want):
        np.testing.assert_array_equal(g, w)


def test_wrapper_checks():
    """The wrapper takes uint8 rows, int32 runs and distances and bool
    bitmaps of one shape."""
    L, S = 2, 64
    args = [torch.zeros((L, S), dtype=torch.uint8), torch.zeros((L, S), dtype=torch.int32),
            torch.zeros((L, S), dtype=torch.int32), torch.zeros((L, S), dtype=torch.bool),
            torch.ones((L, S), dtype=torch.bool)]
    a, flags = pe._finish_analysis(*args)
    assert int(flags.sum()) == 0 and int(a["litlen_hist"].sum()) == 0
    for i, bad in ((1, torch.zeros((L, S), dtype=torch.int64)), (3, torch.zeros((L, S), dtype=torch.uint8)),
                   (4, torch.ones((L, S + 1), dtype=torch.bool))):
        with pytest.raises(ValueError):
            pe._finish_analysis(*args[:i], bad, *args[i + 1 :])
