"""The port's serial host inflater against the JAX package's: every
``GOOD_VECTORS`` entry of ``tests/vectors.py`` decodes to the same bytes and
every ``BAD_VECTORS`` entry fails with the same Reason, whole and in
chunked reads (single bytes and seeded random chunk sizes), under every
padding of the last byte; ``end_exactly`` hands back exactly the bytes
after the payload; and streams of the host encoder decode the same in
both packages. Every comparison is exact."""

from __future__ import annotations

import io
import random
import zlib

import numpy as np
import pytest

from tpu_deflate.codec import inflate_host as ref_ih
from tpu_deflate.streams import inflater as ref_inflater
import tpu_deflate_torch as port
from tpu_deflate_torch.codec import inflate_host as ih
from tpu_deflate_torch.streams import inflater
from tpu_deflate_torch.streams.inflater import InflaterReader

from vectors import BAD_VECTORS, GOOD_VECTORS, bits_to_bytes


def outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "raise", getattr(getattr(e, "reason", None), "name", type(e).__name__)


def chunked(mod, data: bytes, sizes) -> bytes:
    """Read through an end_exactly InflaterReader in the given chunk sizes,
    then the tail after the payload."""
    r = mod.InflaterReader(io.BytesIO(data), end_exactly=True, buffer_size=next(sizes))
    out = bytearray()
    while chunk := r.read(next(sizes)):
        out += chunk
    return bytes(out) + b"|" + r.detach().read()


def _sizes(seed: int, fixed: int | None = None):
    rng = random.Random(seed)
    while True:
        yield fixed if fixed is not None else rng.randint(1, 100)


def _pad(bits: str, pad: str) -> bytes:
    random.seed(len(bits))  # the "random" padding, the same for both packages
    return bits_to_bytes(bits, pad)


@pytest.mark.parametrize("pad", ["0", "1", "random"])
@pytest.mark.parametrize("name,bits,hexout", GOOD_VECTORS, ids=[v[0] for v in GOOD_VECTORS])
def test_good_vector(name, bits, hexout, pad):
    data = _pad(bits, pad)
    expect = bytes.fromhex(hexout.replace(" ", ""))
    assert ih.inflate(data) == ref_ih.inflate(data) == expect
    for seed, fixed in ((1, 1), (2, None), (3, None)):
        got = chunked(inflater, data, _sizes(seed, fixed))
        assert got == chunked(ref_inflater, data, _sizes(seed, fixed)) == expect + b"|"


@pytest.mark.parametrize("pad", ["0", "1"])
@pytest.mark.parametrize("name,bits,reason", BAD_VECTORS, ids=[v[0] for v in BAD_VECTORS])
def test_bad_vector(name, bits, reason, pad):
    data = _pad(bits, pad)
    got = outcome(ih.inflate, data)
    assert got == outcome(ref_ih.inflate, data) == ("raise", reason.name)
    for seed, fixed in ((1, 1), (2, None)):
        assert outcome(chunked, inflater, data, _sizes(seed, fixed)) == got
        assert outcome(chunked, ref_inflater, data, _sizes(seed, fixed)) == got


def test_end_exactly_hands_back_the_tail():
    for name, bits, hexout in GOOD_VECTORS:
        payload = bits_to_bytes(bits, "0")
        for trailer in (b"", b"T", b"TRAILER!" * 3):
            r = InflaterReader(io.BytesIO(payload + trailer), end_exactly=True, buffer_size=5)
            assert r.read() == bytes.fromhex(hexout.replace(" ", ""))
            assert r.is_done
            assert r.detach().read() == trailer, name


def _stream(seed: int) -> tuple[bytes, bytes]:
    rng = np.random.default_rng(seed)
    text = rng.integers(97, 100, 30000, dtype=np.uint8).tobytes()
    data = text[:12000] + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes() + bytes(40000) + text
    return data, port.deflate(data, strategy=port.Lz77HuffmanStrategy(seed % 2 == 0, max_candidates=2), engine="host")


@pytest.mark.parametrize("seed", range(3))
def test_encoder_streams_decode_the_same(seed):
    """Stored, fixed and dynamic blocks past 32 KiB of history, the window
    wrapping, matches of every length; chunk reads of random sizes."""
    data, raw = _stream(seed)
    assert zlib.decompress(raw, -15) == data
    for s in (seed, seed + 10):
        got = chunked(inflater, raw + b"xyz", _sizes(s))
        assert got == chunked(ref_inflater, raw + b"xyz", _sizes(s)) == data + b"|xyz"
    stored = port.deflate(data, effort=0, engine="host")
    assert ih.inflate(stored) == ref_ih.inflate(stored) == data


def test_inflater_api():
    data, raw = _stream(4)
    core = ih.Inflater(io.BytesIO(raw), buffer_size=77)
    assert core.read(0) == b""
    first = core.read(1000)
    assert first == data[:1000] and not core.is_done
    assert first + core.read_all() == data and core.is_done
    assert core.consumed_bytes == len(raw)
    assert outcome(core.read, -1) == ("raise", "ValueError")
    # Sticky errors and closed streams, as the reference's stream shell.
    bad = bits_to_bytes(BAD_VECTORS[0][1], "0")
    for mod in (inflater, ref_inflater):
        r = mod.InflaterReader(io.BytesIO(bad))
        first, again = outcome(r.read), outcome(r.read)
        assert first == again and first[0] == "raise"
        assert outcome(r.detach) == ("raise", "ValueError")
        r.close()
        assert outcome(r.read) == ("raise", "ValueError")
