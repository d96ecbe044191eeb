"""The port's continuous-history encode (tpu_deflate_torch.codec.continuous
on a CPU device, where every kernel wrapper runs its plain version) against
the JAX package's compress_continuous_tpu on the same inputs, byte for
byte at efforts 4 and 5: the inputs of test_continuous_device.py at
block_data 4096, and 200 KiB at block_data 65536. Then round trips through
gzip and the port's own decode. The encoder is integer-only: exact
equality.

A lane's bits depend only on its row (its halo comes from the input), not
on the batch it rides in, so each reference stream is computed once, in
one batch (which keeps the reference's compiles to one per lane count),
and the port's is compared at lane batches 4 and 8."""

from __future__ import annotations

import gzip

import numpy as np
import pytest
import torch

from tpu_deflate.codec import encode_jax as ej
from tpu_deflate_torch.codec import continuous as pc
from tpu_deflate_torch.codec import decode_np
from tpu_deflate_torch.codec import decode_v2 as pv2

CPU = torch.device("cpu")
BLOCK = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(n: int, seed: int = 0) -> bytes:
    """test_continuous_device.py's text: words of a 60-word vocabulary."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 122, rng.integers(3, 9)).astype(np.uint8)) for _ in range(60)]
    out = b" ".join(words[int(i)] for i in rng.integers(0, 60, 4 * n // 5))
    return out[:n]


def _stored_mid_stream() -> bytes:
    rng = np.random.default_rng(7)
    return _text(6000, seed=1) + rng.integers(0, 256, 9000, np.uint8).tobytes() + _text(5000, seed=2)


# name -> data, at blocks of BLOCK bytes
INPUTS = {
    "text": _text(17000),
    "pattern": (_text(3000, seed=3) * 8)[:20000],
    "stored_mid_stream": _stored_mid_stream(),
    **{f"size_{n}": _text(n, seed=n) for n in (0, 1, 5, 4096, 4097)},
}
_REF: dict = {}


def _reference(name: str, effort: int) -> bytes:
    if (name, effort) not in _REF:
        _REF[name, effort] = ej.compress_continuous_tpu(INPUTS[name], effort=effort, block_data=BLOCK)
    return _REF[name, effort]


def _members(gz: bytes) -> int:
    return len(decode_np.split_members(np.frombuffer(gz, np.uint8)))


@pytest.mark.parametrize("effort", [4, 5])
@pytest.mark.parametrize("name", list(INPUTS))
def test_byte_identical_to_reference(name, effort):
    data = INPUTS[name]
    want = _reference(name, effort)
    for lane_batch in (4, 8):
        got = pc.compress_continuous(data, device=CPU, effort=effort, block_data=BLOCK, lane_batch=lane_batch)
        assert got == want, f"lane_batch {lane_batch}"
    assert gzip.decompress(want) == data
    assert _members(want) == 1


def test_byte_identical_at_64k_blocks():
    """The default block of 64 KiB (rows of 98304 columns) on 200 KiB: four
    lanes, the last one short."""
    data = _text(200 * 1024, seed=12)
    want = ej.compress_continuous_tpu(data, effort=4, block_data=65536, lane_batch=4)
    assert pc.compress_continuous(data, device=CPU, effort=4, block_data=65536, lane_batch=4) == want
    assert gzip.decompress(want) == data


def test_history_beats_members():
    """Matches reach the previous block through the halo: the pattern's
    continuous stream is far smaller than per-block members would be."""
    data = INPUTS["pattern"]
    one_block = sum(len(pc.compress_continuous(data[i : i + BLOCK], device=CPU, block_data=BLOCK))
                    for i in range(0, len(data), BLOCK))
    assert len(_reference("pattern", 4)) < 0.8 * one_block


@pytest.mark.parametrize("name", ["text", "stored_mid_stream"])
def test_round_trip_through_the_ports_decoder(name):
    """One member of several Huffman (and stored) blocks decodes with the
    port's own decode on the CPU: the block chain, the device route's tile
    split, resolve and lane CRC."""
    data = INPUTS[name]
    gz = pc.compress_continuous(data, device=CPU, block_data=BLOCK)
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on") == data
