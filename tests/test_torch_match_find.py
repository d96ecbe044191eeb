"""The port's match finder at quality 0 (efforts 0-2) against the eager
version it was factored from, the JAX package's jitted ``_match_find`` and
NumPy mirrors of its kernels (``match_find_cases`` holds the rows and the
shared tests; ``test_torch_match_find_q1.py`` and ``_q2.py`` run them at
qualities 1 and 2), and the wrappers' keys and input checks."""

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
