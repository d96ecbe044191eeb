"""Host CRC-32 with its GF(2) operator algebra, and Adler-32 (a copy of
``tpu_deflate.kernels.checksum``).

The CRC register update is affine over GF(2): processing message ``D``
from register ``i`` gives ``r(D, i) = r(D, 0) XOR L^{8 len(D)}(i)``, with
``L`` the one-zero-bit shift. A linear operator over GF(2)^32 is a
``np.uint32[32]`` array: ``op[j]`` is the operator applied to ``1 << j``.
The lane CRC (``checksum_lanes``) uses these operators to combine chunk
registers and to strip a row's zero tail; ``crc32_combine`` joins two
CRCs the same way. The zlib streams and the preset dictionary id use
``adler32``.
"""

from __future__ import annotations

import functools

import numpy as np

CRC32_POLY = 0xEDB88320  # reflected polynomial
ADLER_MOD = 65521


@functools.lru_cache(maxsize=None)
def _crc_table() -> np.ndarray:
    """Standard reflected CRC-32 table: T[b] = register after byte b from 0."""
    n = np.arange(256, dtype=np.uint32)
    crc = n.copy()
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ np.uint32(CRC32_POLY), crc >> 1)
    return crc


@functools.lru_cache(maxsize=None)
def _crc_tables_slice4() -> tuple[np.ndarray, ...]:
    """Slice-by-4 tables: T_k[b] = L^{8k}(T[b]) so four bytes fold per step."""
    t0 = _crc_table()
    t1 = (t0 >> np.uint32(8)) ^ t0[t0 & np.uint32(0xFF)]
    t2 = (t1 >> np.uint32(8)) ^ t0[t1 & np.uint32(0xFF)]
    t3 = (t2 >> np.uint32(8)) ^ t0[t2 & np.uint32(0xFF)]
    return t0, t1, t2, t3


def _op_identity() -> np.ndarray:
    return (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _op_shift1() -> np.ndarray:
    """The operator L: advance the CRC register by one zero *bit*."""
    basis = _op_identity()
    return np.where(basis & 1, (basis >> 1) ^ np.uint32(CRC32_POLY), basis >> 1).astype(
        np.uint32
    )


def op_apply(op: np.ndarray, values) -> np.ndarray:
    """Apply a GF(2) operator to one or many uint32 values."""
    vals = np.atleast_1d(np.asarray(values, dtype=np.uint32))
    bits = (vals[:, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    contrib = np.where(bits.astype(bool), op[None, :], np.uint32(0))
    out = np.bitwise_xor.reduce(contrib, axis=1)
    return out if np.ndim(values) else out[0]


def op_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Operator composition a∘b (apply b first, then a)."""
    return op_apply(a, b)


@functools.lru_cache(maxsize=None)
def _op_shift_pow2(k: int) -> np.ndarray:
    """L^(2^k): advance the register by 2^k zero bits."""
    if k == 0:
        return _op_shift1()
    half = _op_shift_pow2(k - 1)
    return op_compose(half, half)


def op_shift_n_bits(n: int) -> np.ndarray:
    """L^n for arbitrary n >= 0 by square-and-multiply."""
    result = _op_identity()
    k = 0
    while n:
        if n & 1:
            result = op_compose(_op_shift_pow2(k), result)
        n >>= 1
        k += 1
    return result


def op_invert(op: np.ndarray) -> np.ndarray:
    """Inverse of a GF(2) operator by Gaussian elimination (every CRC
    shift operator is invertible)."""
    # Rows of [M | I] packed as 64-bit ints: low 32 = M row, high 32 = I.
    rows = []
    for i in range(32):
        m = 0
        for j in range(32):
            m |= ((int(op[j]) >> i) & 1) << j
        rows.append(m | (1 << (32 + i)))
    for col in range(32):
        piv = next(r for r in range(col, 32) if (rows[r] >> col) & 1)
        rows[col], rows[piv] = rows[piv], rows[col]
        for r in range(32):
            if r != col and (rows[r] >> col) & 1:
                rows[r] ^= rows[col]
    inv = np.zeros(32, dtype=np.uint32)
    for i in range(32):
        hi = rows[i] >> 32
        for j in range(32):
            if (hi >> j) & 1:
                inv[j] |= np.uint32(1 << i)
    return inv


@functools.lru_cache(maxsize=None)
def _op_unshift_pow2(k: int) -> np.ndarray:
    """L^(-2^k): rewind the register by 2^k zero bits."""
    if k == 0:
        return op_invert(_op_shift1())
    half = _op_unshift_pow2(k - 1)
    return op_compose(half, half)


def op_unshift_n_bits(n: int) -> np.ndarray:
    """L^-n: undo n appended zero bits (left-aligned lane CRC fix-up)."""
    result = _op_identity()
    k = 0
    while n:
        if n & 1:
            result = op_compose(_op_unshift_pow2(k), result)
        n >>= 1
        k += 1
    return result


def crc32_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC of the concatenation A||B given crc32(A), crc32(B), len(B).

    Matches ``zlib.crc32_combine`` semantics (fully conditioned CRCs in and
    out); derivation: crc(A||B) = crc(B) XOR L^{8*len_b}(crc(A)).
    """
    if len_b == 0:
        return crc_a & 0xFFFFFFFF
    return int(op_apply(op_shift_n_bits(8 * len_b), np.uint32(crc_a)) ^ np.uint32(crc_b))


def _crc32_raw_lanes(chunks: np.ndarray) -> np.ndarray:
    """Raw-register CRC (init 0, no conditioning) of each row of ``chunks``
    (lanes, chunk_len) uint8, chunk_len % 4 == 0; slice-by-4 steps."""
    t0, t1, t2, t3 = _crc_tables_slice4()
    lanes, clen = chunks.shape
    assert clen % 4 == 0
    words = np.ascontiguousarray(chunks).view(np.uint32).reshape(lanes, clen // 4)
    if not np.little_endian:  # pragma: no cover
        words = words.byteswap()
    reg = np.zeros(lanes, dtype=np.uint32)
    for i in range(words.shape[1]):
        x = reg ^ words[:, i]
        reg = (
            t3[x & np.uint32(0xFF)]
            ^ t2[(x >> np.uint32(8)) & np.uint32(0xFF)]
            ^ t1[(x >> np.uint32(16)) & np.uint32(0xFF)]
            ^ t0[x >> np.uint32(24)]
        )
    return reg


def _tree_combine_raw(lane_crcs: np.ndarray, chunk_len: int) -> int:
    """Combine raw registers of equal-length contiguous chunks (a power of
    two of them): pairs merge as L^{8 span}(left) XOR right."""
    crcs = lane_crcs
    span = chunk_len
    assert len(crcs) & (len(crcs) - 1) == 0
    while len(crcs) > 1:
        shift = op_shift_n_bits(8 * span)
        crcs = op_apply(shift, crcs[0::2]) ^ crcs[1::2]
        span *= 2
    return int(crcs[0])


def crc32(data, value: int = 0) -> int:
    """CRC-32 of ``data`` (bytes or uint8 array), zlib-compatible."""
    buf = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    n = buf.size
    if n == 0:
        return value & 0xFFFFFFFF
    lanes = 1
    while lanes < 65536 and lanes * 256 < n:
        lanes *= 2
    chunk = -(-n // (4 * lanes)) * 4  # ceil, multiple of 4 for slice-by-4
    pad = lanes * chunk - n
    if pad:
        buf = np.concatenate([np.zeros(pad, dtype=np.uint8), buf])  # front pad is free
    total_raw = _tree_combine_raw(_crc32_raw_lanes(buf.reshape(lanes, chunk)), chunk)
    init_reg = np.uint32((value ^ 0xFFFFFFFF) & 0xFFFFFFFF)
    shifted = op_apply(op_shift_n_bits(8 * n), init_reg)
    return int(np.uint32(total_raw) ^ shifted ^ np.uint32(0xFFFFFFFF))


def adler32(data, value: int = 1) -> int:
    """Adler-32 of ``data``, zlib-compatible. Fully vectorized prefix sums."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    n = buf.size
    # Process in blocks small enough that int64 sums cannot overflow:
    # within a block of m bytes, the weighted sum is <= m*(m+1)/2*255 < 2^62
    # for m <= 2^26.
    block = 1 << 24
    pos = 0
    while pos < n:
        d = buf[pos : pos + block].astype(np.int64)
        m = d.size
        s = int(d.sum())
        w = int((d * np.arange(m, 0, -1, dtype=np.int64)).sum())  # sum (m-i)*d_i, i0-based weight m..1
        b = (b + m * a + w) % ADLER_MOD
        a = (a + s) % ADLER_MOD
        pos += m
    return ((b << 16) | a) & 0xFFFFFFFF


def adler32_combine(adler_a: int, adler_b: int, len_b: int) -> int:
    """Adler-32 of A||B from the two parts (for distributed shard combine).

    With a(X) = 1 + sum(X) and b(X) = len(X) + weighted-sum(X), one gets
    a(A||B) = a(A) + a(B) - 1 and b(A||B) = b(A) + b(B) + len(B)*(a(A) - 1),
    everything mod 65521 (same identity zlib's adler32_combine uses).
    """
    rem = len_b % ADLER_MOD
    a1 = adler_a & 0xFFFF
    b1 = (adler_a >> 16) & 0xFFFF
    a2 = adler_b & 0xFFFF
    b2 = (adler_b >> 16) & 0xFFFF
    a = (a1 + a2 + ADLER_MOD - 1) % ADLER_MOD
    b = (b1 + b2 + rem * (a1 + ADLER_MOD - 1)) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF
