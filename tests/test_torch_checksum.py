"""The port's checksums against the JAX package and zlib: the lane CRC-32
(tpu_deflate_torch.kernels.checksum_lanes, plain version on CPU tensors)
against checksum_jax.crc32_lanes_raw8 and its host finish, and the host
copies (kernels.checksum) against tpu_deflate.kernels.checksum. Integer
results, compared exactly."""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.kernels import checksum as ck_ref
from tpu_deflate.kernels import checksum_jax as cj

from tpu_deflate_torch.kernels import checksum as ck
from tpu_deflate_torch.kernels import checksum_lanes as cl


def _rows(width: int) -> tuple[np.ndarray, list[int]]:
    rng = np.random.default_rng(3)
    lens = [0, 1, min(12345, width - 1), width]
    rows = np.zeros((len(lens), width), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows, lens


@pytest.mark.parametrize("width", [4096, 65536])
def test_lane_crc_matches_jax_and_zlib(width):
    rows, lens = _rows(width)
    raw = cl.crc32_lanes_raw8(torch.from_numpy(rows))
    assert raw.dtype == torch.int64 and raw.shape == (len(lens),)
    K8, lvl8 = cj.crc_matrices8(width // cj.CHUNK_BYTES)
    want = np.asarray(cj.crc32_lanes_raw8(jnp.asarray(rows.astype(np.int32)), K8, lvl8))
    np.testing.assert_array_equal(raw.numpy(), want.astype(np.int64))
    crcs = cl.crc32_finish_leftaligned(raw.numpy(), np.array(lens), width)
    np.testing.assert_array_equal(crcs, cj.crc32_finish_leftaligned(want, np.array(lens), width))
    for i, n in enumerate(lens):
        assert int(crcs[i]) == zlib.crc32(rows[i, :n].tobytes())
        # raw register of the whole row = the table CRC from 0 with no conditioning
        assert int(raw[i]) == zlib.crc32(rows[i].tobytes(), 0xFFFFFFFF) ^ 0xFFFFFFFF


def test_lane_crc_tables_match_reference():
    np.testing.assert_array_equal(cl._chunk_matrix(cl.CHUNK_BYTES), cj._chunk_matrix(cj.CHUNK_BYTES))
    bits = cj._level_matrices(cj.CHUNK_BYTES, 7)
    ops = cl.level_ops(cl.CHUNK_BYTES, 7)
    j32 = np.arange(32, dtype=np.uint32)
    np.testing.assert_array_equal((ops[:, :, None] >> j32) & 1, bits.astype(np.uint32))


def test_lane_crc_rejects_bad_widths():
    with pytest.raises(ValueError):
        cl.crc32_lanes_raw8(torch.zeros((2, 1536), dtype=torch.uint8))  # 3 chunks
    with pytest.raises(ValueError):
        cl.crc32_lanes_raw8(torch.zeros((2, 4096), dtype=torch.int32))


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 70001])
def test_host_crc32_matches_zlib_and_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert ck.crc32(data) == ck_ref.crc32(data) == zlib.crc32(data)
    assert ck.crc32(data, 12345) == zlib.crc32(data, 12345)


def test_operators_match_reference():
    for n in (0, 1, 8, 4096, 123457):
        np.testing.assert_array_equal(ck.op_shift_n_bits(n), ck_ref.op_shift_n_bits(n))
        np.testing.assert_array_equal(ck.op_unshift_n_bits(n), ck_ref.op_unshift_n_bits(n))
        v = np.uint32(0xDEADBEEF)
        assert ck.op_apply(ck.op_unshift_n_bits(n), ck.op_apply(ck.op_shift_n_bits(n), v)) == v
