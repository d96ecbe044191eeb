"""The port's match finder at quality 0 (efforts 0-2) against the eager
version it was factored from, the JAX package's jitted ``_match_find`` and
NumPy mirrors of its kernels (``match_find_cases`` holds the rows and the
shared tests; ``test_torch_match_find_q1.py`` and ``_q2.py`` run them at
qualities 1 and 2), the wrappers' keys and input checks, and a mirror of
``match_keys_kernel``'s runs of 4 positions a lane, a warp's lanes side by
side, held against ``_match_keys_plain``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from match_find_cases import (  # noqa: F401  (the shared tests and their fixtures)
    MAX_WORDS,
    _one_torch_thread,
    batch,
    mf,
    test_bucket_mirror,
    test_distance_limit,
    test_f1_lane_differs_from_reference,
    test_match_find_composes_the_pieces,
    test_plain_pieces_equal_before,
    test_plain_pieces_equal_reference,
    test_select_mirror,
    torch_args,
)
from tpu_deflate_torch.codec import encode as pe

QUALITY = 0


def test_keys_are_the_family_hashes():
    """``match_keys`` (its plain version) against the hashes computed here
    in uint32 from the zero-extended rows: -1 before hstart and from the
    lane's length on."""
    data, lengths, _hist, hstart = batch("halo")
    L, S = data.shape
    ext = np.zeros((L, S + 6), np.uint32)
    ext[:, :S] = data
    w = ext[:, :S] | ext[:, 1 : S + 1] << 8 | ext[:, 2 : S + 2] << 16 | ext[:, 3 : S + 3] << 24
    b45 = ext[:, 4 : S + 4] | ext[:, 5 : S + 5] << 8
    windows = {pe.FAMILY_4: w, pe.FAMILY_3: w & 0xFFFFFF, pe.FAMILY_6: w ^ (b45 * np.uint32(0x9E3779B1))}
    col = np.arange(S)[None, :]
    valid = (col < lengths[:, None]) & (col >= hstart[:, None])
    families = (pe.FAMILY_6, pe.FAMILY_4, pe.FAMILY_3)
    got = pe.match_keys(*(torch.from_numpy(a) for a in (data, lengths)), families, torch.from_numpy(hstart)).numpy()
    for f, keys in zip(families, got):
        want = np.where(valid, ((windows[f] * np.uint32(2654435761)) >> 16).astype(np.int32), -1)
        assert np.array_equal(keys, want), f"family {f}"


def test_wrappers_check_their_inputs():
    data, lengths, hist, hstart = torch_args("halo")
    q = torch.zeros(data.shape, dtype=torch.int64)
    keys = torch.zeros((2, *data.shape), dtype=torch.int32)
    links = torch.zeros((2, *data.shape), dtype=torch.uint16)
    for call in (
        lambda: pe.match_keys(data.to(torch.int32), lengths, (pe.FAMILY_4,)),
        lambda: pe.match_keys(data, lengths, (7,)),
        lambda: pe.match_keys(data, lengths, ()),
        lambda: pe.match_keys(data, lengths, (pe.FAMILY_4,), hstart[:2]),
        lambda: pe.match_chain(keys.to(torch.int64)),
        lambda: pe.match_chain(keys[0]),
        lambda: pe.match_bucket(links[:, :, :8].contiguous(), data, (4, 2), (2, 2)),
        lambda: pe.match_bucket(links, data, (4, 2), (2, MAX_WORDS + 1)),
        lambda: pe.match_bucket(links, data, (4,), (2,)),
        lambda: pe.match_bucket(links.to(torch.int32), data, (4, 2), (2, 2)),
        lambda: pe.match_bucket(torch.zeros((4, *data.shape), dtype=torch.uint16), data, (4,) * 4, (2,) * 4),
        lambda: pe.match_select(data, lengths[:2], True, q, q, None, hist, hstart),
        lambda: pe.match_select(data, lengths, True, q, q.to(torch.int32)),
        lambda: pe.match_select(data, lengths, True, q, q[:, :8]),
    ):
        with pytest.raises(ValueError):
            call()


KEY_THREADS, KEY_RUNS = 256, 4  # threads a block of match_keys_kernel; runs of 4 positions a thread
KEY_WARP = 128 * KEY_RUNS  # positions a warp
KEY_BLOCK = KEY_WARP * KEY_THREADS // 32  # positions a block


def keys_mirror(data: np.ndarray, lengths: np.ndarray, families: tuple, hstart: np.ndarray | None,
                aligned: bool) -> np.ndarray:
    """``match_keys_kernel``'s method -> (F, L, S) int32. Lane k of warp w
    of block b takes the runs of 4 positions from i0 = b KEY_BLOCK + w
    KEY_WARP + 128 r + 4 k, r < KEY_RUNS. On the vector path (rows 4-byte
    aligned, keys 16-byte aligned, S a multiple of 4: ``aligned``) the lane
    loads the word at i0 of each run (0 past S) and lanes 0 and 1 the two
    words after the warp's last run; the words at i0 + 4 and i0 + 8 come by
    shuffles from lanes k + 1 and k + 2, or for lanes 31 and 30, 31 from
    lanes 0 and 0, 1 of the next run; each family's 4 keys leave as one
    16-byte store where i0 < S. Off it each lane reads its 12 bytes one at a
    time (zeros past S) and stores each key below S. Position j's windows
    are funnel shifts of the three words by 8 j bits."""
    L, S = data.shape
    vec = aligned and S % 4 == 0
    hs = np.zeros(L, np.int64) if hstart is None else hstart.astype(np.int64)
    span = -(-S // KEY_BLOCK) * KEY_BLOCK  # the blocks' positions
    n = span + KEY_WARP + 16  # and the words the warps' last loads reach
    ext = np.zeros((L, n + 3), np.uint64)
    ext[:, :S] = data
    words = ext[:, :n] | ext[:, 1 : n + 1] << np.uint64(8) | ext[:, 2 : n + 2] << np.uint64(16) | \
        ext[:, 3 : n + 3] << np.uint64(24)  # words[:, p]: the zero-extended row's bytes p..p+3
    keys = np.full((len(families), L, S), 0x7EADBEEF, np.int64)  # every key is written
    lanes = np.arange(32)
    for wbase in range(0, span, KEY_WARP):
        # x[r][:, k]: lane k's word of run r (lanes 0, 1 only past the last run), 0 past S.
        x = []
        for r in range(KEY_RUNS + 1):
            p = wbase + 128 * r + 4 * lanes
            x.append(np.where(((r < KEY_RUNS) | (lanes < 2)) & (p < S), words[:, p], np.uint64(0)))
        for r in range(KEY_RUNS):
            i0 = wbase + 128 * r + 4 * lanes  # (32,)
            if vec:
                w0 = x[r]
                w1 = np.where(lanes == 31, x[r + 1][:, [0]], x[r][:, (lanes + 1) % 32])
                w2 = np.where(lanes >= 30, x[r + 1][:, (lanes + 2) % 32], x[r][:, (lanes + 2) % 32])
            else:  # byte by byte, zeros past S
                w0, w1, w2 = (words[:, i0 + 4 * q] for q in range(3))
            for q, wq in enumerate((w0, w1, w2)):  # the words at i0 + 4 q
                assert np.array_equal(wq, words[:, i0 + 4 * q])
            for f, family in enumerate(families):
                for j in range(4):
                    sh = np.uint64(8 * j)
                    a = ((w0 | w1 << np.uint64(32)) >> sh) & np.uint64(0xFFFFFFFF)
                    b = ((w1 | w2 << np.uint64(32)) >> sh) & np.uint64(0xFFFFFFFF)
                    if family == pe.FAMILY_3:
                        a = a & np.uint64(0xFFFFFF)
                    elif family == pe.FAMILY_6:
                        a = a ^ ((b & np.uint64(0xFFFF)) * np.uint64(0x9E3779B1) & np.uint64(0xFFFFFFFF))
                    h = (((a * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)) >> np.uint64(16)).astype(np.int64)
                    i = i0 + j
                    h = np.where((i[None] >= hs[:, None]) & (i[None] < lengths[:, None]), h, -1)
                    store = (i0 < S) if vec else (i < S)  # a run's 16-byte store, or one key below S
                    assert (i[store] < S).all(), "a store past the row"
                    keys[f][:, i[store]] = h[:, store]
    return keys.astype(np.int32)


KEY_FAMILIES = ((pe.FAMILY_4,), (pe.FAMILY_3,), (pe.FAMILY_6,), (pe.FAMILY_4, pe.FAMILY_3),
                (pe.FAMILY_4, pe.FAMILY_3, pe.FAMILY_6), (pe.FAMILY_6, pe.FAMILY_4, pe.FAMILY_3))


@pytest.mark.parametrize("S", [1, 4, 5, 16, 23, 24, 25, 40, 4095, 4096, 4097, 4100, 4112, 8200])
@pytest.mark.parametrize("with_hstart", [False, True])
def test_keys_mirror_runs(S, with_hstart):
    """The key kernel's mirror against ``_match_keys_plain`` for F = 1, 2
    and 3 (every family alone, the effort-2 pair, the three in two
    orders), with and without hstart, on rows of S a multiple of 4 (the
    vector path; S of 4100 and 8200 end inside a warp's runs, where the
    last words read come from past S as zeros) and not (1, 5, 23, 25, 4095,
    4097: the scalar path), rows of repeats, zeros and random bytes,
    lengths of 0, 1, S - 1, S and past S. Where S is a multiple of 4 the
    scalar path (a row not 4-byte aligned) runs too."""
    rng = np.random.default_rng(S * 2 + with_hstart)
    L = 5
    data = rng.integers(0, 256, (L, S)).astype(np.uint8)
    data[1] = np.resize(np.frombuffer(b"abcabd", np.uint8), S)
    data[2] = 0
    data[3, S // 2 :] = 0xFF
    lengths = np.array([S, 0, 1, max(S - 1, 0), S + 7], np.int32)
    hstart = rng.integers(0, S + 1, L).astype(np.int32) if with_hstart else None
    if with_hstart:
        hstart[0] = 0
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    for families in KEY_FAMILIES:
        want = pe._match_keys_plain(t(data), t(lengths), families, t(hstart)).numpy()
        for aligned in (True, False) if S % 4 == 0 else (False,):
            got = keys_mirror(data, lengths, families, hstart, aligned)
            assert np.array_equal(got, want), (families, aligned)
        assert np.array_equal(pe.match_keys(t(data), t(lengths), families, t(hstart)).numpy(), want)
