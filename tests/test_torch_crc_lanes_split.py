"""A mirror of the lane CRC's algorithm (csrc/crc32_lanes.cu), written here
in NumPy. A row is cut into units of 32 P bytes, P = 64 (16 for rows of 512
and 1024 bytes), one unit a warp step: lane j folds the P bytes at P j of
the unit into its register, acc = A(acc) ^ crc(piece), where crc(piece) is
P / 8 slice-by-8 steps from 0 and A (the shift past one unit) four
byte-sliced lookups, skipped on the first step. A row's units are split
over C blocks (a cluster) of 8 warps, S consecutive units a warp, C
doubling while the launch has fewer than 256 blocks and each warp keeps two
steps (``checksum_lanes.kernel_split``). Each lane then
shifts its register past the P (31 - j) bytes behind its last piece by 32
select-and-XOR steps over its operator words, the warp XORs its lanes and
shifts the result past the rest of the row with one operator of its own
(``checksum_lanes.warp_ops``: lane b selects the image of bit b, a warp
XOR applies it), and the row's register is the XOR of its warps'. The
tables are the kernel's own (``checksum_lanes.kernel_tables``).

The mirror is held equal to the port's plain version
``checksum_lanes.crc32_lanes_raw8_plain`` and to the JAX package's
``checksum_jax.crc32_lanes_raw8`` with ``crc_matrices8``, and its finished
registers to ``zlib.crc32``, at widths of 512, 1024, 65536 and 524288
bytes (both piece sizes, 1 to 8 warps a block, clusters of 1 to 8 blocks,
1 to 4 steps a warp), on all-zero, all-0xFF and random rows, with row
counts that do not fill a block of rows, and on the row counts of the
decode's and the encoder's batches. Integer results, compared exactly."""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.kernels import checksum_jax as cj

from tpu_deflate_torch.kernels import checksum as ck
from tpu_deflate_torch.kernels import checksum_lanes as cl

CHUNK = cl.CHUNK_BYTES


def tables(P: int) -> dict:
    """The kernel's tables for piece size P: t8, ta (this P's unit shift)
    and opl (this P's lane operators, [bit][lane])."""
    t = cl.kernel_tables()
    at = 8 * 256 + (4 * 256 + 32 * 32) * cl.KERNEL_PIECES.index(P)
    assert t.size == 8 * 256 + (4 * 256 + 32 * 32) * len(cl.KERNEL_PIECES)
    return {"t8": t[: 8 * 256].reshape(8, 256), "ta": t[at : at + 4 * 256].reshape(4, 256),
            "opl": t[at + 4 * 256 : at + 4 * 256 + 32 * 32].reshape(32, 32)}


def apply_bits(ops: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply an operator (its 32 image words, one per bit, indexed along
    the last axis of ops) to v: the XOR of the images of v's set bits."""
    bits = (v[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return np.bitwise_xor.reduce(np.where(bits.astype(bool), ops, np.uint32(0)), axis=-1)


def step8(T: dict, r: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """One slice-by-8 step: the register after 8 more bytes (x, y as
    little-endian words)."""
    t8 = T["t8"]
    lo = x ^ r
    out = np.zeros_like(lo)
    for b in range(4):
        out ^= t8[7 - b][(lo >> np.uint32(8 * b)) & np.uint32(0xFF)]
        out ^= t8[3 - b][(y >> np.uint32(8 * b)) & np.uint32(0xFF)]
    return out


def fold(T: dict, acc: np.ndarray, q: np.ndarray, first: bool) -> np.ndarray:
    """acc = A(acc) ^ crc(piece), A skipped on the first step; q (..., P / 4)
    little-endian words."""
    c = np.zeros_like(acc)
    for i in range(0, q.shape[-1], 2):
        c = step8(T, c, q[..., i], q[..., i + 1])
    if not first:
        for b in range(4):
            c ^= T["ta"][b][(acc >> np.uint32(8 * b)) & np.uint32(0xFF)]
    return c


def mirror_crc(rows: np.ndarray) -> np.ndarray:
    """rows (L, W) uint8 -> (L,) uint32 raw registers, as the kernel
    computes them."""
    L, W = rows.shape
    P, C, wu, S = cl.kernel_split(L, W)
    T = tables(P)
    # (L, warps of the row, S steps, 32 lanes, P / 4 words): warp g = r wu +
    # w, its step k lane j the P bytes at P j of unit g S + k.
    words = rows.reshape(L, C * wu, S, 32, P).view("<u4")
    acc = np.zeros((L, C * wu, 32), np.uint32)
    for k in range(S):
        acc = fold(T, acc, words[:, :, k], k == 0)
    v = np.bitwise_xor.reduce(apply_bits(T["opl"].T, acc), axis=-1)  # (L, warps)
    v = apply_bits(cl.warp_ops(W, P, C, wu, S), v)
    return np.bitwise_xor.reduce(v, axis=1)


def _jax(rows: np.ndarray) -> np.ndarray:
    K8, lvl8 = cj.crc_matrices8(rows.shape[1] // cj.CHUNK_BYTES)
    return np.asarray(cj.crc32_lanes_raw8(jnp.asarray(rows.astype(np.int32)), K8, lvl8)).astype(np.uint32)


def _rows(kind: str, L: int, W: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros((L, W), np.uint8)
    if kind == "ones":
        return np.full((L, W), 0xFF, np.uint8)
    return np.random.default_rng(W + L).integers(0, 256, (L, W), dtype=np.uint8)


WIDTHS = [512, 1024, 65536, 524288]


@pytest.mark.parametrize("kind", ["zeros", "ones", "random"])
@pytest.mark.parametrize("width", WIDTHS)
def test_mirror_matches_plain_jax_and_zlib(width, kind):
    L = 3 if width < 524288 else 1
    rows = _rows(kind, L, width)
    got = mirror_crc(rows)
    np.testing.assert_array_equal(got, cl.crc32_lanes_raw8(torch.from_numpy(rows)).numpy().astype(np.uint32))
    np.testing.assert_array_equal(got, _jax(rows))
    lens = np.full(L, width)
    for i, c in enumerate(cl.crc32_finish_leftaligned(got, lens, width)):
        assert int(c) == zlib.crc32(rows[i].tobytes())


def test_mirror_on_left_aligned_members():
    """Rows holding members of 0, 1, 12345 and 65536 bytes with zero tails,
    as the decode and the encoder pass them: finished by the host as the
    port finishes them, equal to zlib."""
    rng = np.random.default_rng(3)
    width = 65536
    lens = np.array([0, 1, 12345, width])
    rows = np.zeros((len(lens), width), np.uint8)
    for i, k in enumerate(lens):
        rows[i, :k] = rng.integers(0, 256, k, dtype=np.uint8)
    got = mirror_crc(rows)
    np.testing.assert_array_equal(got, _jax(rows))
    for i, c in enumerate(cl.crc32_finish_leftaligned(got, lens, width)):
        assert int(c) == zlib.crc32(rows[i, : lens[i]].tobytes())


@pytest.mark.parametrize("L", [1, 3, 64, 178, 256])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_split_covers_each_row_once(L, n):
    """The units of the blocks and warps tile the row exactly once, in
    order, and a cluster has at most 8 blocks; the 64 KiB rows of the
    decode's 256- and 178-row batches take clusters of 1 and 2 blocks, the
    encoder's 64-row batches of 2."""
    P, C, wu, S = cl.kernel_split(L, n * CHUNK)
    assert 1 <= C <= 8 and 1 <= wu <= 8 and S >= 1 and C * wu * S * 32 * P == n * CHUNK
    starts = [(r * wu + w) * S for r in range(C) for w in range(wu)]
    assert starts == list(range(0, n * CHUNK // (32 * P), S))
    if n == 128:
        assert (P, C, wu) == (64, {1: 2, 3: 2, 64: 2, 178: 2, 256: 1}[L], 8)


def test_warp_operators_of_a_decode_batch():
    """The warps' operators at the decode's 178-row split: the shift past
    the bytes of the row behind each warp's span."""
    W = 65536
    P, C, wu, S = cl.kernel_split(178, W)
    ops = cl.warp_ops(W, P, C, wu, S)
    assert ops.shape == (C * wu, 32)
    for g in range(C * wu):
        np.testing.assert_array_equal(ops[g], ck.op_shift_n_bits(8 * (W - (g + 1) * S * 32 * P)))


@pytest.mark.parametrize("L", [64, 178])
def test_mirror_on_batch_row_counts(L):
    """Random 64 KiB rows at the encoder's and the decode's row counts."""
    rows = _rows("random", L, 65536)
    np.testing.assert_array_equal(mirror_crc(rows), cl.crc32_lanes_raw8_plain(torch.from_numpy(rows)).numpy())


@pytest.mark.parametrize("P", cl.KERNEL_PIECES)
def test_tables(P):
    """The kernel's tables: slice-by-8 entries against zlib, A against the
    shift past 32 P zero bytes, each lane's operator against the shift past
    P (31 - lane) zero bytes."""
    T = tables(P)
    for b in (0, 1, 0x80, 0xFF):
        for k in range(8):
            raw = zlib.crc32(bytes([b]) + bytes(k), 0xFFFFFFFF) ^ 0xFFFFFFFF
            assert int(T["t8"][k][b]) == raw
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << 32, 16, dtype=np.uint64).astype(np.uint32)
    a = np.zeros_like(vals)
    for b in range(4):
        a ^= T["ta"][b][(vals >> np.uint32(8 * b)) & np.uint32(0xFF)]
    np.testing.assert_array_equal(a, ck.op_apply(ck.op_shift_n_bits(8 * 32 * P), vals))
    for j in range(32):
        np.testing.assert_array_equal(T["opl"][:, j], ck.op_shift_n_bits(8 * P * (31 - j)))
