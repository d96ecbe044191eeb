"""The port's device LZ77 resolve (tpu_deflate_torch.codec.resolve, plain
versions on CPU tensors) against the JAX package's resolve_pallas, whose
Pallas kernels run in interpret mode as tests/test_resolve_device.py runs
them. Inputs are made with numpy from a seed; the resolve is integer-only,
so every comparison is exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_deflate.codec import resolve_pallas as rp

from test_resolve_device import _gen_tokens
from tpu_deflate_torch.codec import resolve as rs

N = rs.N_POS
MATCH = rs.TOKEN_MATCH_BIT


def _lane(tokens) -> np.ndarray:
    row = np.full(N, -1, np.int32)
    row[: len(tokens)] = tokens
    return row


def _styles(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_lane(_gen_tokens(rng, s, 30000)) for s in ("text", "records", "rle")])


def _case(name: str) -> np.ndarray:
    """(L, N_POS) int32 token lanes for one named case."""
    rng = np.random.default_rng(5)
    if name == "styles":  # text, records and rle lanes (test_resolve_device.py:18)
        return _styles(11)
    if name == "copy_before_start":
        return np.stack([_lane([65, MATCH | 5 << 16 | 3]), _lane([66, 67, MATCH | 40 << 16 | 1])])
    if name == "big_dist":  # dist-1 = 0x8000 at a match start
        lits = rng.integers(0, 256, 40000).tolist()
        return np.stack([_lane(lits + [MATCH | 5 << 16 | 0x8000, MATCH | 9 << 16 | 3])])
    if name == "empty":
        return np.stack([_lane([]), _lane([7])])
    if name == "long_region":  # constant-distance regions past 32 KiB: the cap on k binds
        return np.stack([
            _lane([65] + [MATCH | 258 << 16 | 0] * 250),
            _lane([1, 2, 3, 4] + [MATCH | 258 << 16 | 3] * 250),
            _lane([7, 8, 9] + [MATCH | 200 << 16 | 2] * 300),
        ])
    if name == "over_64k":  # total above N_POS: positions past it are dropped
        lits = rng.integers(0, 256, 40000).tolist()
        runs = [MATCH | 258 << 16 | int(d) for d in rng.integers(0, 300, 230)]
        return np.stack([_lane(lits + runs)])
    raise KeyError(name)


CASES = ("styles", "copy_before_start", "big_dist", "empty", "long_region", "over_64k")


@pytest.mark.parametrize("hist", [0, rs.TAIL])
@pytest.mark.parametrize("case", CASES)
def test_expand_matches_pallas(case, hist):
    tok = _case(case)
    y0, src, summ = rs.expand(torch.from_numpy(tok), hist=hist)
    ry0, rsrc, rsumm = (np.asarray(a) for a in rp._expand_jit(tok, hist=hist, interpret=True))
    np.testing.assert_array_equal(y0.numpy(), ry0)
    np.testing.assert_array_equal(src.numpy(), rsrc)
    np.testing.assert_array_equal(summ.numpy()[:, :3], rsumm[:, :3])
    assert (summ.numpy()[:, 3:] == 0).all()
    if case == "over_64k":
        assert int(summ[0, 1]) > N
    if case == "empty":
        assert summ[0].tolist() == [N, 0, 0, 0, 0, 0, 0, 0]
        assert (y0[0] == 0).all() and (src[0] == torch.arange(N)).all()


@pytest.mark.parametrize("hist", [0, rs.TAIL])
@pytest.mark.parametrize("case", ["styles", "copy_before_start", "long_region", "over_64k"])
def test_sweep_matches_pallas(case, hist):
    """Both sweeps on the same expand outputs; a random tail when hist is
    32 KiB. The residue (status row 0) must agree; row 1 is a diagnostic."""
    tok = _case(case)
    L = tok.shape[0]
    y0, src, _summ = (np.asarray(a) for a in rp._expand_jit(tok, hist=hist, interpret=True))
    rng = np.random.default_rng(9)
    tail = (rng.integers(0, 256, (L, rs.TAIL)) if hist else np.zeros((L, rs.TAIL))).astype(np.int32)
    y, status = rs.sweep(*(torch.from_numpy(np.array(a)) for a in (tail, y0, src)))
    ry, rst = (np.asarray(a) for a in rp._sweep_jit(tail, y0, src, interpret=True))
    np.testing.assert_array_equal(y.numpy(), ry)
    np.testing.assert_array_equal(status.numpy()[:, 0], rst[:, 0])
    assert (status.numpy()[:, 0] == 0).all()


def test_resolve_tokens_device_matches_reference():
    tok = _styles(11)
    y, summ = rs.resolve_tokens_device(torch.from_numpy(tok))
    ry, rsumm, _rounds, _unres = rp.resolve_tokens_device(tok, interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(summ.numpy()[:, :4], np.asarray(rsumm)[:, :4])
    for i in range(tok.shape[0]):
        ref = rp.resolve_reference(tok[i].astype(np.int64))
        assert y[i, : len(ref)].numpy().astype(np.uint8).tobytes() == ref


def _long_member(seed: int, target: int) -> list[int]:
    """~target bytes of literals, long-distance and RLE matches
    (test_resolve_device.py:84)."""
    rng = np.random.default_rng(seed)
    toks: list[int] = []
    out = 0
    while out < target:
        roll = rng.random()
        if roll < 0.35 or out < 8:
            toks.append(int(rng.integers(0, 256)))
            out += 1
        elif roll < 0.55:
            run = int(rng.integers(3, 259))
            dist = int(rng.integers(1, min(out, 32768) + 1))
            toks.append(MATCH | run << 16 | (dist - 1))
            out += run
        else:
            run = int(rng.integers(3, 259))
            dist = int(rng.integers(1, 5))
            toks.append(MATCH | run << 16 | (dist - 1))
            out += run
    return toks


def test_split_and_tiled_resolve_long_member():
    toks = np.array(_long_member(7, 3 * N // 2 + 12345), np.int32)
    tiles = rs.split_tokens_tiles(toks)
    np.testing.assert_array_equal(tiles, rp.split_tokens_tiles(toks))
    assert tiles.shape[0] == 2
    y, summs = rs.resolve_tokens_tiled(torch.from_numpy(tiles[None]))
    ry, rsumms, _unres = rp.resolve_tokens_tiled(tiles[None], interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(summs.numpy()[..., :4], np.asarray(rsumms)[..., :4])
    ref = rp.resolve_reference(toks.astype(np.int64))
    got = b"".join(y[0, t, : int(summs[0, t, 1])].numpy().astype(np.uint8).tobytes() for t in range(2))
    assert got == ref


def test_split_tokens_tiles_edges():
    for toks in ([], [5], [MATCH | 200 << 16 | 0] * 400, _long_member(3, 3 * N + 7)):
        arr = np.array(toks, np.int32)
        np.testing.assert_array_equal(rs.split_tokens_tiles(arr), rp.split_tokens_tiles(arr))


def test_resolve_big_streams_matches_reference():
    streams = [
        np.array(_long_member(1, 70000), np.int32),
        np.array(_long_member(2, 1000), np.int32),
        np.array([65, MATCH | 5 << 16 | 3], np.int32),  # copy before start: handed back
    ]
    outs, resid = rs.resolve_big_streams(streams, torch.device("cpu"))
    routs, rresid = rp.resolve_big_streams(streams, interpret=True)
    np.testing.assert_array_equal(resid, rresid)
    assert resid.tolist()[:2] == [0, 0] and resid[2] > 0
    for got, want, toks in zip(outs[:2], routs[:2], streams):
        np.testing.assert_array_equal(got, want)
        assert got.tobytes() == rp.resolve_reference(toks.astype(np.int64))


def test_wrappers_check_inputs():
    tok = torch.full((1, N), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        rs.expand(tok[:, :100].contiguous())
    with pytest.raises(ValueError):
        rs.expand(tok, hist=5)
    with pytest.raises(ValueError):
        rs.sweep(torch.zeros((1, 10), dtype=torch.int32), tok, tok)
    assert rs.TAIL == rp.TAIL_ROWS * 128 and rs.W_CAP == rp.W_CAP and rs.N_POS == rp.N_POS
