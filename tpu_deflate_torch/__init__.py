"""PyTorch + CUDA port of tpu_deflate.

``tpu_deflate/`` (JAX + Pallas for the TPU) is the unchanged reference;
this package mirrors its layout (``codec/``, ``format/``, ``kernels/``,
``streams/``, ``dist/``, ``engine.py``, ``config.py``, ``catalog.py``,
``stats.py``, ``csrc/`` for the CUDA kernels) and keeps its own copies of
the JAX-free pieces it needs. It imports ``torch`` and never ``jax``, and
nothing of ``tpu_deflate``; ``native.py`` binds the shared C core
``native/deflate_core.c`` on its own.

The one-shot API below (``deflate``, ``gzip_compress``,
``gzip_decompress``, ``zlib_compress``, ``zlib_decompress``) runs on the
card unless the caller passes ``engine="host"``: on the card the encodes
are ``engine.compress``'s (raw DEFLATE and zlib take its continuous-history
member's payload) and the decodes the wave kernels' (``engine.decompress``,
``decode_v2.inflate_raw_end_v2``, Adler-32 by ``adler32_device``);
``engine="host"`` is the reference's host engine, its ``engine="host"``
branches: the strategy encoder and the serial inflater in NumPy and Python,
byte-identical to the reference's one-shot API. A ``strategy`` and a preset
dictionary are the host engine's alone. The streaming classes in
``streams/`` and the statistics in ``stats.py`` are host code, as in the
reference; the member catalog (``catalog.py``) decodes on the card unless
built with ``engine="host"``.
"""

from __future__ import annotations

import io

import numpy as np

from .codec import deflate_encode as strategies
from .codec.deflate_encode import (
    BinarySplitStrategy,
    FULL_DYNAMIC,
    FULL_STATIC,
    LITERAL_DYNAMIC,
    LITERAL_STATIC,
    Lz77HuffmanStrategy,
    MultiStrategy,
    RLE_DYNAMIC,
    RLE_STATIC,
    StoredStrategy,
    Strategy,
)
from .codec.inflate_host import Inflater, inflate
from .format.errors import DataFormatError, Reason
from .format.gzip_meta import GzipMetadata, OperatingSystem
from .format.zlib_meta import CompressionLevel, ZlibMetadata
from .kernels.checksum import adler32, adler32_combine, crc32, crc32_combine
from .streams.deflater import Deflater
from .streams.gzip_stream import GzipReader, GzipWriter
from .streams.inflater import InflaterReader
from .streams.markable import MarkableFileStream
from .streams.zlib_stream import ZlibReader, ZlibWriter

__version__ = "0.1.0"

# Effort levels -> strategy compositions, the reference's map: e1 is
# RLE_DYNAMIC; e2+ parse lazily over 3/4/8-byte-hash candidate levels.
_EFFORT_STRATEGIES = {
    0: StoredStrategy(),
    1: RLE_DYNAMIC,
    2: Lz77HuffmanStrategy(True, lazy=True, max_candidates=16),
    3: Lz77HuffmanStrategy(True, lazy=True, max_candidates=32),
    4: MultiStrategy(
        [StoredStrategy(), Lz77HuffmanStrategy(True, lazy=True, max_candidates=32)]
    ),
    5: MultiStrategy(
        [
            StoredStrategy(),
            BinarySplitStrategy(
                MultiStrategy(
                    [
                        Lz77HuffmanStrategy(True, lazy=True, max_candidates=64),
                        Lz77HuffmanStrategy(False, lazy=True, max_candidates=64),
                    ]
                ),
                min_block_len=4096,
            ),
        ]
    ),
}


def strategy_for_effort(effort: int) -> Strategy:
    """Map an effort level (0..5) to a strategy composition."""
    if effort not in _EFFORT_STRATEGIES:
        raise ValueError(f"effort must be in 0..5, got {effort}")
    return _EFFORT_STRATEGIES[effort]


def _card(engine: str):
    """None for ``engine="host"``; for ``engine="cuda"`` the CUDA device
    (raises where there is none)."""
    if engine == "host":
        return None
    if engine != "cuda":
        raise ValueError(f"engine={engine!r}: expected 'cuda' or 'host'")
    from .engine import _cuda

    return _cuda(engine)


def _host_only(what: str, given) -> None:
    """The card's branches refuse what only the host engine does."""
    if given is not None:
        raise ValueError(f"{what} is the host engine's: pass engine='host'")


def deflate(
    data: bytes, *, effort: int = 2, strategy: Strategy | None = None, engine: str = "cuda"
) -> bytes:
    """One-shot raw-DEFLATE compress: on the card the continuous-history
    encode (one stream, the deepest candidate set at effort 5), with
    ``engine="host"`` the strategy encoder (the reference's host engine)."""
    device = _card(engine)
    if device is not None:
        _host_only("strategy", strategy)
        strategy_for_effort(effort)
        return _raw_deflate_on(data, effort, device)
    sink = io.BytesIO()
    d = Deflater(sink, strategy=strategy or strategy_for_effort(effort))
    d.write(data)
    d.finish()
    return sink.getvalue()


def _raw_deflate_on(data: bytes, effort: int, device) -> bytes:
    """The payload of ``codec.continuous.compress_continuous``'s member: one
    raw DEFLATE stream encoded on ``device``."""
    from .codec.continuous import compress_continuous
    from .format.gzip_meta import read_gzip_header

    member = compress_continuous(data, device=device, effort=effort)
    head = io.BytesIO(member)
    read_gzip_header(head)
    return member[head.tell() : -8]


def gzip_compress(
    data: bytes,
    *,
    effort: int = 2,
    strategy: Strategy | None = None,
    metadata: GzipMetadata | None = None,
    engine: str = "cuda",
) -> bytes:
    """One-shot gzip compress: on the card ``engine.compress`` (TD-indexed
    members at efforts 0-3, one member at 4-5), with ``engine="host"`` one
    member of the strategy encoder (the reference's host engine)."""
    device = _card(engine)
    if device is not None:
        _host_only("strategy", strategy)
        strategy_for_effort(effort)
        from .engine import compress

        return compress(data, engine=engine, effort=effort, metadata=metadata)
    sink = io.BytesIO()
    w = GzipWriter(sink, metadata, strategy=strategy or strategy_for_effort(effort))
    w.write(data)
    w.finish()
    return sink.getvalue()


def gzip_decompress(data: bytes, *, multi_member: bool = True, engine: str = "cuda") -> bytes:
    """One-shot gzip decompress: on the card ``engine.decompress``'s decode
    (a stream with no TD member index in the C core, as there), with
    ``engine="host"`` the serial host inflater (the reference's host
    engine). With ``multi_member`` False only the first member."""
    device = _card(engine)
    if device is None:
        return GzipReader(io.BytesIO(data), multi_member=multi_member).read()
    from . import native
    from .codec.decode_np import member_at
    from .codec.decode_v2 import gzip_decompress_v2

    if not multi_member:
        first = member_at(np.frombuffer(data, np.uint8), 0)
        if first is None:
            return native.gzip_decompress_serial(data, multi_member=False)
        data = data[: first.end]
    return gzip_decompress_v2(data, device=device)


def zlib_compress(
    data: bytes,
    *,
    effort: int = 2,
    strategy: Strategy | None = None,
    preset_dictionary: bytes | None = None,
    engine: str = "cuda",
) -> bytes:
    """One-shot zlib compress: on the card the raw stream of :func:`deflate`
    and ``adler32_device``'s trailer, with ``engine="host"`` the strategy
    encoder (the reference's host engine)."""
    device = _card(engine)
    if device is not None:
        _host_only("strategy", strategy)
        _host_only("a preset dictionary", preset_dictionary)
        strategy_for_effort(effort)
        from .kernels.checksum_lanes import adler32_device

        raw = _raw_deflate_on(data, effort, device)
        return ZlibMetadata().to_bytes() + raw + adler32_device(data, device=device).to_bytes(4, "big")
    sink = io.BytesIO()
    w = ZlibWriter(
        sink,
        strategy=strategy or strategy_for_effort(effort),
        preset_dictionary=preset_dictionary,
    )
    w.write(data)
    w.finish()
    return sink.getvalue()


def zlib_decompress(
    data: bytes, *, preset_dictionary: bytes | None = None, engine: str = "cuda"
) -> bytes:
    """One-shot zlib decompress: on the card the wave kernels and
    ``adler32_device``, with ``engine="host"`` the serial host inflater (the
    reference's host engine)."""
    device = _card(engine)
    if device is None:
        return ZlibReader(io.BytesIO(data), preset_dictionary=preset_dictionary).read()
    from .codec.decode_v2 import inflate_raw_end_v2
    from .format.errors import raise_unexpected_end
    from .kernels.checksum_lanes import adler32_device

    _host_only("a preset dictionary", preset_dictionary)
    # The host reader's order: the header's Reason, the payload's, a short
    # trailer, then the Adler-32.
    head = io.BytesIO(data)
    _host_only("a preset dictionary", ZlibMetadata.read(head).preset_dictionary)
    payload = data[head.tell() :]
    out, used = inflate_raw_end_v2(payload, device=device)
    trailer = payload[used : used + 4]
    if len(trailer) < 4:
        raise_unexpected_end()
    if int.from_bytes(trailer, "big") != adler32_device(out, device=device):
        raise DataFormatError(Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression Adler-32 mismatch")
    return out
