"""Adler-32 of one buffer (``checksum_lanes.adler32_device``: the sums by
``adler_sums_kernel`` of csrc/adler32.cu on the card) on the CPU: against
zlib.adler32 and the JAX package's ``checksum_jax.adler32_device``, with
and without an init value, at sizes around the 16-byte vectors and
zlib's 5552-byte and 65521 blocks; then a NumPy mirror of the kernel (the
bytes before the first 16-byte boundary and after the last vector read by
scalar loads, the vectors by a grid-stride loop whose weights step down
from one modulo a vector, 64-bit sums a thread, a partial pair a block,
the partials added) against the plain sums ``adler_sums_plain``, at every
start address modulo 16. Integer-only, so every comparison is exact."""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from tpu_deflate.kernels import checksum_jax as cj

from tpu_deflate_torch.kernels import checksum_lanes as cl

CPU = torch.device("cpu")
SIZES = (1, 15, 16, 17, 5552, 5553, 65521 * 3 + 1)
MOD = 65521
THREADS = 256


def _data(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_matches_zlib_and_reference(n):
    data = _data(n, n)
    want = zlib.adler32(data)
    assert cl.adler32_device(data, device=CPU) == want == cj.adler32_device(data)
    mid = n // 3
    init = zlib.adler32(data[:mid])
    assert cl.adler32_device(data[mid:], init, device=CPU) == zlib.adler32(data[mid:], init) == want
    assert cl.adler32_device(data, 0x12345678, device=CPU) == zlib.adler32(data, 0x12345678)


def test_tensor_input_and_empty_buffer():
    data = _data(1000, 3)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    assert cl.adler32_device(t) == zlib.adler32(data)
    assert cl.adler32_device(b"", 77, device=CPU) == 77


def blocks(n: int) -> int:
    """td_adler_blocks: a block a 256 vectors, at most 8 a SM."""
    return min(max(-(-(n // 16) // THREADS), 1), 132 * 8)


def mirror_sums(buf: np.ndarray, address: int) -> tuple[int, int]:
    """The kernel's sums of buf, laid out from an address with this
    remainder modulo 16."""
    n = buf.size
    head = min((16 - address % 16) % 16, n)
    nvec = (n - head) // 16
    tail = head + 16 * nvec
    G = blocks(n)
    stride = G * THREADS
    part = np.zeros((G, 2), np.uint64)
    d = buf.astype(np.uint64)
    # scalar bytes: thread i of the grid takes index i, i + stride, ...
    scalar = np.concatenate([np.arange(head), np.arange(tail, n)])
    owner = (np.arange(scalar.size) % stride) // THREADS
    w = ((n - scalar) % MOD).astype(np.uint64)
    np.add.at(part[:, 0], owner, d[scalar])
    np.add.at(part[:, 1], owner, d[scalar] * w)
    # vectors: vector k by thread k mod stride, weights r - j wrapped
    k = np.arange(nvec)
    i0 = head + 16 * k
    r = (n - i0) % MOD
    j = np.arange(16)
    wv = (r[:, None] - j[None, :]) % MOD
    assert (wv == (n - (i0[:, None] + j[None, :])) % MOD).all()
    vec = d[i0[:, None] + j[None, :]]
    assert ((vec * wv.astype(np.uint64)).sum(1) < 2**32).all()  # a vector's sum fits its uint32
    owner = (k % stride) // THREADS
    np.add.at(part[:, 0], owner, vec.sum(1))
    np.add.at(part[:, 1], owner, (vec * wv.astype(np.uint64)).sum(1))
    s, ws = part.sum(0)  # the last block adds the partials
    return int(s), int(ws)


@pytest.mark.parametrize("n", SIZES + (300000,))
def test_mirror_matches_plain_at_every_alignment(n):
    buf = np.frombuffer(_data(n, n + 1), np.uint8)
    want = cl.adler_sums_plain(torch.from_numpy(buf.copy())).tolist()
    for address in range(16):
        assert list(mirror_sums(buf, address)) == want


def test_wrapper_takes_the_plain_version_on_the_cpu():
    d = torch.from_numpy(np.frombuffer(_data(5000, 9), np.uint8).copy())
    before = cl.LAUNCHES["adler_sums"]
    assert torch.equal(cl.adler_sums(d), cl.adler_sums_plain(d))
    assert cl.LAUNCHES["adler_sums"] == before
    with pytest.raises(ValueError):
        cl.adler_sums(d.to(torch.int32))
