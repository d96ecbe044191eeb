"""Per-lane CRC-32 of resolved rows on the device (counterpart of
``tpu_deflate.kernels.checksum_jax``: ``crc32_lanes_raw8``,
``crc_matrices8``, ``crc32_finish_leftaligned``, ``crc32_members``).

:func:`crc32_lanes_raw8` returns, for each row of an (L, W) uint8 tensor
(W a power-of-two multiple of 512 bytes), the raw CRC register (init 0, no
conditioning) of the whole row. The decode rows are left-aligned with a
zero tail, so :func:`crc32_finish_leftaligned` strips the tail on the host
with L^-8k and applies the standard init/final XORs.

The kernel (``csrc/crc32_lanes.cu``) is a table CRC of each 512-byte chunk
and a combine tree with the 32 x 32 GF(2) level matrices, kept as 32
words each. The plain version is the reference's GF(2) algorithm: a
bit-matrix product per chunk, then the same tree as bit-matrix products,
in float64 (0/1 sums of at most 4096 terms are exact) with the parity
taken as an integer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .._build import LAUNCHES
from .checksum import (
    _crc_table,
    _op_shift_pow2,
    _op_unshift_pow2,
    op_apply,
    op_compose,
    op_shift_n_bits,
)

CHUNK_BYTES = 512


@functools.lru_cache(maxsize=None)
def _chunk_matrix(chunk_bytes: int) -> np.ndarray:
    """K: (8 chunk_bytes, 32) 0/1; raw register of a chunk = bits @ K mod 2,
    bits byte 0 first, LSB first within a byte."""
    table = _crc_table()
    K = np.zeros((8 * chunk_bytes, 32), dtype=np.float64)
    # Bit j of byte p contributes L8^(chunk_bytes-1-p)(T[1 << j]).
    contrib = np.array([table[1 << j] for j in range(8)], dtype=np.uint32)
    for p in range(chunk_bytes - 1, -1, -1):
        K[p * 8 : p * 8 + 8, :] = (contrib[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        if p > 0:
            contrib = op_apply(_op_shift_pow2(3), contrib)  # advance 8 zero bits
    return K


@functools.lru_cache(maxsize=None)
def level_ops(chunk_bytes: int, levels: int) -> np.ndarray:
    """(levels, 32) uint32: level l is the operator L^{8 chunk_bytes 2^l}
    (word j = its image of 1 << j), which shifts a left half past its
    right half of chunk_bytes 2^l bytes."""
    out = np.zeros((levels, 32), dtype=np.uint32)
    op = op_shift_n_bits(8 * chunk_bytes)
    for l in range(levels):
        out[l] = op
        op = op_compose(op, op)
    return out


def _levels(width: int) -> int:
    n_chunks = width // CHUNK_BYTES
    return max(1, int(n_chunks).bit_length() - 1)


def crc32_lanes_raw8_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain lane CRC: rows (L, W) uint8 -> (L,) int64 raw registers."""
    L, W = rows.shape
    dev = rows.device
    n = W // CHUNK_BYTES
    f64 = torch.float64
    shifts = torch.arange(8, device=dev)
    bits = ((rows.to(torch.int64).view(L * n, CHUNK_BYTES, 1) >> shifts) & 1).reshape(L * n, -1)
    K = torch.from_numpy(_chunk_matrix(CHUNK_BYTES)).to(dev)
    crc_bits = (bits.to(f64) @ K).to(torch.int64) & 1
    crc_bits = crc_bits.view(L, n, 32)
    ops = level_ops(CHUNK_BYTES, _levels(W))
    j32 = np.arange(32, dtype=np.uint32)
    level = 0
    while crc_bits.shape[1] > 1:
        # M[j, k] = bit k of the operator's image of basis j: bits_out = bits_in @ M.
        M = torch.from_numpy(((ops[level][:, None] >> j32) & 1).astype(np.float64)).to(dev)
        left, right = crc_bits[:, 0::2], crc_bits[:, 1::2]
        shifted = (left.to(f64) @ M).to(torch.int64) & 1
        crc_bits = shifted ^ right
        level += 1
    weights = torch.tensor([1 << k for k in range(32)], dtype=torch.int64, device=dev)
    return (crc_bits[:, 0, :] * weights).sum(1)


def crc32_lanes_raw8(rows: torch.Tensor) -> torch.Tensor:
    """Lane CRC kernel: rows (L, W) uint8 -> (L,) int64 raw registers of
    each whole row."""
    _build.check_tensor("rows", rows, torch.uint8, 2)
    L, W = rows.shape
    n = W // CHUNK_BYTES
    _build.require(
        W % CHUNK_BYTES == 0 and n & (n - 1) == 0 and n <= 1024,
        f"rows: width {W} must be 512 times a power of two, at most 1024 chunks",
    )
    if not _build.on_card(rows):
        return crc32_lanes_raw8_plain(rows)
    dev = rows.device
    levels = _levels(W)
    ops = torch.from_numpy(level_ops(CHUNK_BYTES, levels).view(np.int32)).to(dev)
    raw = torch.empty(L, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_crc32_lanes(
            rows.data_ptr(), ops.data_ptr(), raw.data_ptr(), L, W, levels, _build.stream(dev)
        )
    _build.check(err, "td_crc32_lanes")
    LAUNCHES["crc32_lanes"] += 1
    return raw.to(torch.int64) & 0xFFFFFFFF


def _apply_bits(values: np.ndarray, n: np.ndarray, op_pow2) -> np.ndarray:
    """Apply L^{+-n_i} to values[i], lane-parallel: one operator per bit of n."""
    out = values.astype(np.uint32).copy()
    k = 0
    while (n >> k).any():
        sel = ((n >> k) & 1).astype(bool)
        if sel.any():
            out[sel] = op_apply(op_pow2(k), out[sel])
        k += 1
    return out


def crc32_finish_leftaligned(raw: np.ndarray, lengths: np.ndarray, width: int) -> np.ndarray:
    """Final CRC-32s from left-aligned raw lane registers: raw[i] is the
    register of (row_i || zeros up to width); strip the tail with L^-8k,
    then apply the init and final XORs. Returns (L,) uint32."""
    lengths = np.asarray(lengths, np.int64)
    r = _apply_bits(np.asarray(raw, np.uint32), 8 * (width - lengths), _op_unshift_pow2)
    ones = np.full(lengths.shape, 0xFFFFFFFF, np.uint32)
    shifted = _apply_bits(ones, 8 * lengths, _op_shift_pow2)
    return r ^ shifted ^ np.uint32(0xFFFFFFFF)


def crc32_members(rows: torch.Tensor, lengths: np.ndarray) -> np.ndarray:
    """Final CRC-32 of each member row (counterpart of
    ``checksum_jax.crc32_members``): rows (L, W) uint8 hold each member's
    first ``lengths[i]`` bytes, zero after them, as the encoder's padded
    batch does. The lane CRC runs where the rows lie (the kernel on the
    card, the plain version on the CPU); the host strips the zero tails.
    Returns (L,) uint32."""
    raw = crc32_lanes_raw8(rows)
    return crc32_finish_leftaligned(raw.cpu().numpy(), lengths, rows.shape[1])
