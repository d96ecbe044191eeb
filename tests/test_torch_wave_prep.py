"""Port host prep (tpu_deflate_torch.codec.wave_prep) against the JAX
package's decode_jax_v2: the same streams give the same wave dicts, key by
key, so the two packages cut waves into identical shapes and tables. All
comparisons are exact equality (the host prep is integer-only)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate.codec.profile import profile_compress_host
from tpu_deflate.format.errors import DataFormatError

from tpu_deflate_torch.format import errors as port_errors

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import wave_prep as wp

from vectors import BAD_VECTORS, GOOD_VECTORS, bits_to_bytes

CPU = torch.device("cpu")


def _profile_payloads(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(40)]
    data = np.concatenate([words[i] for i in rng.integers(0, 40, n // 3)]).tobytes()[:n]
    buf = np.frombuffer(profile_compress_host(data), np.uint8)
    return [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]


@pytest.fixture(scope="module")
def profile_payloads():
    return _profile_payloads(3, 90000)


def _assert_wave_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_prep_wave_profile_streams(profile_payloads):
    for lanes in (None, 4, 16):
        got = wp._prep_wave(profile_payloads, lanes)
        want = v2._prep_wave(profile_payloads, lanes, buckets=dp.P_BUCKETS_PALLAS)
        _assert_wave_equal(got, want)


def test_wave_arrays_k1_groups_min_tok(profile_payloads):
    payloads = profile_payloads
    L, P = 4, 32768
    rows = np.zeros((L, P), np.uint8)
    row_bits = np.zeros(L, np.int64)
    for i, p in enumerate(payloads[:L]):
        n = min(len(p), P)
        rows[i, :n] = np.frombuffer(p, np.uint8, n)
        row_bits[i] = n * 8
    hp = dj.parse_headers_batch(rows, row_bits)
    got, got_shift = wp._wave_arrays(rows, row_bits, hp)
    want, want_shift = v2._wave_arrays(rows, row_bits, hp)
    _assert_wave_equal(got, want)
    np.testing.assert_array_equal(got_shift, want_shift)
    np.testing.assert_array_equal(wp.lane_min_tok_bits(hp), v2.lane_min_tok_bits(hp))
    bitpos = [0, 3, 0, 5]
    assert wp._k1_groups(payloads[:L], bitpos) == v2._k1_groups(payloads[:L], bitpos)


_VECTORS = [(n, b) for n, b, _ in GOOD_VECTORS] + [(n, b) for n, b, _ in BAD_VECTORS]


@pytest.mark.parametrize("name,bits", _VECTORS, ids=[v[0] for v in _VECTORS])
def test_prep_wave_vectors(name, bits):
    """Every conformance vector: the same wave dict, or the same Reason."""
    payload = bits_to_bytes(bits, "0")
    results = []
    for prep in (
        lambda: wp._prep_wave([payload], 4),
        lambda: v2._prep_wave([payload], 4, buckets=dp.P_BUCKETS_PALLAS),
    ):
        try:
            results.append(prep())
        except (DataFormatError, port_errors.DataFormatError) as e:
            results.append(e.reason.name)
    got, want = results
    if isinstance(want, dict):
        _assert_wave_equal(got, want)
    else:
        assert got == want
    assert wp._k1_groups([payload], [0]) == v2._k1_groups([payload], [0])


def test_build_meta_matches(profile_payloads):
    w = wp._prep_wave(profile_payloads, 4)
    got = dk.build_meta(wp.wave_to_tensors(w, CPU))
    assert got.dtype == torch.int32 and got.shape == (4, wp.META_W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(dp.build_meta(w)))


def test_wave_to_tensors_keys(profile_payloads):
    w = wp._prep_wave(profile_payloads, 4)
    wt = wp.wave_to_tensors(w, CPU)
    assert wt.keys() == w.keys()
    assert wt["_min_tok_bits"] == w["_min_tok_bits"]
    assert wt["ll_sat"].dtype == torch.int32
    np.testing.assert_array_equal(wt["ll_sat"].numpy().view(np.uint32), w["ll_sat"])
    np.testing.assert_array_equal(wt["grid"].numpy(), w["grid"])


def test_constants_match_reference():
    assert wp.P_BUCKETS_PALLAS == dp.P_BUCKETS_PALLAS
    assert wp.K1_CHOICES == dp.K1_CHOICES
    assert (wp.W_P, wp.E_WIN, wp.META_W) == (dp.W_P, dp.E_WIN, dp.META_W)
    assert (wp.V2_L_BUCKETS, wp.WAVE_BYTES_CAP) == (v2.V2_L_BUCKETS, v2.WAVE_BYTES_CAP)
    assert wp.TOKEN_MATCH_BIT == v2.TOKEN_MATCH_BIT
    for name in ("MA_LLSAT", "MA_LLPACK", "MA_LLP2", "MA_LLP3", "MA_DSAT", "MA_DPACK",
                 "MA_LLNLIVE", "MA_DNLIVE", "MA_DEMPTY", "MA_PBITS", "MA_EOB", "MA_INIT2",
                 "MA_INIT3", "MA_MW", "MA_DPERM", "ROW_COUNT", "ROW_EOB_POS", "ROW_EOB_TOK",
                 "ROW_ERR_TOK", "ROW_SIZE_SUM", "ROW_EOB_HIT", "ROW_ERR_HIT", "ROW_OVERFLOW"):
        assert getattr(wp, name) == getattr(dp, name), name
    for name in ("_ERR_END", "_ERR_RESERVED_LEN", "_ERR_RESERVED_DIST", "_ERR_EMPTY_DIST",
                 "_PAD_PAYLOAD", "SENT_EOB", "SENT_ERR", "ACC_BIAS"):
        assert getattr(wp, name) == getattr(v2, name), name


def test_port_imports_no_jax():
    code = (
        "import sys, tpu_deflate_torch, tpu_deflate_torch.engine, "
        "tpu_deflate_torch.codec.decode_v2, tpu_deflate_torch._build, "
        "tpu_deflate_torch.native; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_chip_smoke_names_only_the_port():
    """chip_smoke.py names the port and no module of the JAX package."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "tpu_deflate_torch" in names
    bad = {n for n in names if n.split(".")[0] in ("tpu_deflate", "jax", "jaxlib")}
    assert not bad, bad
