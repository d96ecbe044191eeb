"""Per-lane CRC-32 of resolved rows on the device (counterpart of
``tpu_deflate.kernels.checksum_jax``: ``crc32_lanes_raw8``,
``crc_matrices8``, ``crc32_finish_leftaligned``, ``crc32_members``).

:func:`crc32_lanes_raw8` returns, for each row of an (L, W) uint8 tensor
(W a power-of-two multiple of 512 bytes), the raw CRC register (init 0, no
conditioning) of the whole row. The decode rows are left-aligned with a
zero tail, so :func:`crc32_finish_leftaligned` strips the tail on the host
with L^-8k and applies the standard init/final XORs.

The kernel (``csrc/crc32_lanes.cu``) splits each row over a cluster of
blocks (:func:`kernel_split`), folds 64-byte pieces per lane with table
lookups and combines the lanes' registers with GF(2) operators kept as 32
words each (:func:`kernel_tables`), then shifts each warp's register to the
end of the row with an operator of its own (:func:`warp_ops`) before the
XOR of all of them. The plain version is the reference's GF(2) algorithm:
a bit-matrix product per chunk, then a tree of bit-matrix products with
the level matrices, in float64 (0/1 sums of at most 4096 terms are exact)
with the parity taken as an integer.

:func:`adler32_device` takes Adler-32's two sums of one buffer with one
launch of ``csrc/adler32.cu`` (:func:`adler_sums`; plain
:func:`adler_sums_plain`) and folds them on the host.
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


KERNEL_PIECES = (16, 64)  # bytes a lane folds a step: 16 for rows of 1 or 2 chunks, else 64
KERNEL_WARPS = 8  # warps a block
KERNEL_MIN_STEPS = 2  # warp steps a warp where the row has them: the second load overlaps the first fold
KERNEL_MAX_CLUSTER = 8  # blocks a row
KERNEL_TARGET_BLOCKS = 256  # blocks a launch should have


def kernel_split(L: int, width: int) -> tuple[int, int, int, int]:
    """How the kernel cuts a batch of L rows of ``width`` bytes: (P bytes a
    lane folds a step, C blocks (one cluster) a row, wu warps a block, S
    steps a warp). A warp step covers 32 P bytes. C doubles from 1 while the
    launch has fewer than KERNEL_TARGET_BLOCKS blocks and each warp keeps
    KERNEL_MIN_STEPS steps, up to 8: the decode's 256- and 178-row batches
    of 64 KiB rows take C = 1 and 2, the encoder's 64-row batches C = 2."""
    P = KERNEL_PIECES[1] if width >= 4 * CHUNK_BYTES else KERNEL_PIECES[0]
    units = width // (32 * P)
    C = 1
    while (
        C < KERNEL_MAX_CLUSTER
        and L * C < KERNEL_TARGET_BLOCKS
        and units // (2 * C) >= KERNEL_WARPS * KERNEL_MIN_STEPS
    ):
        C *= 2
    per_block = units // C
    wu = min(KERNEL_WARPS, per_block)
    return P, C, wu, per_block // wu


@functools.lru_cache(maxsize=None)
def kernel_tables() -> np.ndarray:
    """The kernel's tables as one uint32 array: slice-by-8 (8, 256), T_k[b]
    = the register after byte b and k zero bytes; then for each piece size
    P in KERNEL_PIECES the shift past one warp step of 32 P bytes,
    byte-sliced (4, 256), A[i][v] = the shift of v << 8 i, and the lane
    operators (32 bits, 32 lanes), the image of bit b under the shift past
    P (31 - lane) bytes."""
    t8 = [_crc_table()]
    for _ in range(7):
        prev = t8[-1]
        t8.append((prev >> np.uint32(8)) ^ t8[0][prev & np.uint32(0xFF)])
    parts = [np.stack(t8).ravel()]
    v = np.arange(256, dtype=np.uint32)
    for piece in KERNEL_PIECES:
        a_op = op_shift_n_bits(8 * 32 * piece)
        parts.append(np.stack([op_apply(a_op, v << np.uint32(8 * i)) for i in range(4)]).ravel())
        lane_ops = [op_shift_n_bits(8 * piece * (31 - j)) for j in range(32)]
        parts.append(np.stack(lane_ops, axis=1).ravel())  # [bit][lane]
    return np.concatenate(parts).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def warp_ops(width: int, P: int, C: int, wu: int, S: int) -> np.ndarray:
    """(C wu, 32) uint32: for warp g of a row, the operator that shifts a
    register at the end of the warp's span past the rest of the row,
    width - (g + 1) S 32 P bytes (word b = the image of bit b)."""
    return np.stack([op_shift_n_bits(8 * (width - (g + 1) * S * 32 * P)) for g in range(C * wu)])


_DEVICE_TABLES: dict = {}


def _on_device(key, make, dev: torch.device) -> torch.Tensor:
    """make() (a uint32 array) on the device, uploaded once per key."""
    t = _DEVICE_TABLES.get((dev, key))
    if t is None:
        t = torch.from_numpy(make().view(np.int32)).to(dev)
        _DEVICE_TABLES[(dev, key)] = t
    return t


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
    if rows.data_ptr() % 16:
        rows = rows.clone()  # the kernel reads 16 bytes a load
    split = kernel_split(L, W)
    tables = _on_device("tables", kernel_tables, dev)
    ops = _on_device((W, *split), lambda: warp_ops(W, *split), dev)
    raw = torch.empty(L, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_crc32_lanes(
            rows.data_ptr(), tables.data_ptr(), ops.data_ptr(), raw.data_ptr(), L, W, *split, _build.stream(dev)
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


def crc32_fold_tiles(raws: np.ndarray, lengths: np.ndarray, width: int) -> np.ndarray:
    """Final CRC-32 of each lane from the raw registers of its T tiles:
    raws (L, T), raws[i, t] the register of tile t of lane i, each tile
    ``width`` bytes, the lane's bytes tile 0 .. tile T-1 with zeros after
    its first ``lengths[i]``. Folds ``acc = L^{8 width}(acc) ^ raw_t`` in
    tile order, then strips the zero tail (:func:`crc32_finish_leftaligned`
    over T width bytes). Host arithmetic on T words a lane; returns (L,)
    uint32."""
    raws = np.asarray(raws, np.uint32)
    shift = op_shift_n_bits(8 * width)
    acc = raws[:, 0]
    for t in range(1, raws.shape[1]):
        acc = op_apply(shift, acc) ^ raws[:, t]
    return crc32_finish_leftaligned(acc, lengths, raws.shape[1] * width)


ROW_BYTES_MAX = CHUNK_BYTES * 1024  # the widest row the lane CRC takes


def _device(device) -> torch.device:
    """The device a one-buffer checksum runs on: CUDA unless the caller
    names another; raises where CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("crc32_device/adler32_device need a CUDA device, and none is available")
    return dev


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.asarray(data, np.uint8).ravel()


def crc32_device(data, value: int = 0, *, device=None) -> int:
    """zlib-compatible CRC-32 of one buffer with the lane CRC (counterpart
    of ``checksum_jax.crc32_device``): the bytes go to ``device`` (CUDA by
    default) as rows of a power-of-two width up to 512 KiB, zero after the
    last byte; the host folds the rows' registers (:func:`crc32_fold_tiles`)
    and then the init ``value``, whose register the n bytes shift by 8n
    bits. A uint8 tensor's bytes are taken where they lie, ``device``
    ignored (no upload)."""
    if isinstance(data, torch.Tensor):
        _build.require(data.dtype == torch.uint8, f"data: dtype {data.dtype}, expected torch.uint8")
        src = data.reshape(-1)
        dev = src.device
    else:
        src = torch.from_numpy(_as_bytes(data).copy())
        dev = _device(device)
    n = src.numel()
    if n == 0:
        return value & 0xFFFFFFFF
    width = min(max(CHUNK_BYTES, 1 << (n - 1).bit_length()), ROW_BYTES_MAX)
    L = -(-n // width)
    rows = torch.zeros(L * width, dtype=torch.uint8, device=dev)
    rows[:n] = src.to(dev)
    raw = crc32_lanes_raw8(rows.view(L, width)).cpu().numpy()
    crc = crc32_fold_tiles(raw[None], np.array([n]), width)[0]
    return int(crc ^ op_apply(op_shift_n_bits(8 * n), np.uint32(value & 0xFFFFFFFF)))


ADLER_MOD = 65521


def adler_sums_plain(d: torch.Tensor) -> torch.Tensor:
    """Plain Adler-32 sums of n bytes d (uint8, 1-d): (sum d_i, sum d_i *
    ((n - i) mod 65521)) as a (2,) int64 tensor, exact for n below 2**39
    (each product is below 2**24)."""
    n = d.numel()
    x = d.to(torch.int64)
    w = (n - torch.arange(n, device=d.device)) % ADLER_MOD
    return torch.stack([x.sum(), (x * w).sum()])


def adler_sums(d: torch.Tensor) -> torch.Tensor:
    """The sums of :func:`adler_sums_plain`: on the card one launch of
    ``td_adler_sums`` (16-byte vector reads, per-block 64-bit partials,
    the last block adding them; no copy of the buffer), on the CPU the
    plain version."""
    _build.check_tensor("d", d, torch.uint8, 1)
    if not _build.on_card(d):
        return adler_sums_plain(d)
    dev = d.device
    n = d.numel()
    lib = _build.load()
    partial = torch.empty(2 * lib.td_adler_blocks(n), dtype=torch.int64, device=dev)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    ticket = _build.kept_zero("adler_ticket", dev, 1)
    with torch.cuda.device(dev):
        err = lib.td_adler_sums(d.data_ptr(), n, partial.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                                _build.stream(dev))
    if err:
        _build.drop_kept_zero("adler_ticket", dev)
    _build.check(err, "td_adler_sums")
    LAUNCHES["adler_sums"] += 1
    return out


def adler32_device(data, value: int = 1, *, device=None) -> int:
    """zlib-compatible Adler-32 of one buffer (counterpart of
    ``checksum_jax.adler32_device``): the bytes go to ``device`` (CUDA by
    default), :func:`adler_sums` takes the byte sum and the sum of each
    byte times (n - index) mod 65521 there, exact for any buffer below
    2**39 bytes, and the host folds them with the init ``value``. A uint8
    tensor's bytes are taken where they lie, ``device`` ignored (no
    upload)."""
    if isinstance(data, torch.Tensor):
        _build.require(data.dtype == torch.uint8, f"data: dtype {data.dtype}, expected torch.uint8")
        d = data.reshape(-1).contiguous()
    else:
        d = torch.from_numpy(_as_bytes(data).copy()).to(_device(device))
    n = d.numel()
    if n == 0:
        return value & 0xFFFFFFFF
    a, b = value & 0xFFFF, (value >> 16) & 0xFFFF
    s, ws = (int(x) % ADLER_MOD for x in adler_sums(d).cpu())
    b = (b + n * a + ws) % ADLER_MOD
    a = (a + s) % ADLER_MOD
    return (b << 16) | a


def crc32_members(rows: torch.Tensor, lengths: np.ndarray) -> np.ndarray:
    """Final CRC-32 of each member row (counterpart of
    ``checksum_jax.crc32_members``): rows (L, W) uint8 hold each member's
    first ``lengths[i]`` bytes, zero after them, as the encoder's padded
    batch does. The lane CRC runs where the rows lie (the kernel on the
    card, the plain version on the CPU); the host strips the zero tails.
    Returns (L,) uint32."""
    raw = crc32_lanes_raw8(rows)
    return crc32_finish_leftaligned(raw.cpu().numpy(), lengths, rows.shape[1])
