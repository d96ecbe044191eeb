"""Raw-DEFLATE decompressor stream (a copy of ``tpu_deflate.streams.inflater``,
the analog of the reference library's ``InflaterInputStream``).

A state-machine shell over the serial inflater with the reference's stream
discipline:

- the first raised exception is latched ("sticky") and re-raised on every
  later read;
- closed streams raise on read;
- ``end_exactly=True`` supports the container handoff contract: after the
  final block, the bytes over-read past the DEFLATE payload are recoverable
  via :meth:`InflaterReader.detach`, so a container can parse its trailer
  and any following members.

An optional ``preset_dictionary`` primes the LZ77 window (decode side of
zlib FDICT).
"""

from __future__ import annotations

import io

import numpy as np

from ..codec.inflate_host import Inflater as _Core
from ..format.tables import WINDOW_SIZE


class _ClosedState:
    pass


class InflaterReader:
    """File-like reader producing decompressed bytes from a DEFLATE source."""

    def __init__(
        self,
        source,
        *,
        end_exactly: bool = False,
        buffer_size: int = 16 * 1024,
        preset_dictionary: bytes | None = None,
    ):
        if buffer_size < 1:
            raise ValueError("buffer_size must be positive")
        self._core = _Core(source, buffer_size=buffer_size)
        self._source = source
        self._end_exactly = end_exactly
        self._sticky: BaseException | None = None
        self._closed = False
        if preset_dictionary:
            self._prime_window(preset_dictionary)

    def _prime_window(self, dictionary: bytes) -> None:
        d = np.frombuffer(dictionary[-WINDOW_SIZE:], dtype=np.uint8)
        self._core._emit_literal_bytes(d)
        self._core._pending.clear()

    # ------------------------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("Stream already closed")
        if self._sticky is not None:
            raise self._sticky
        try:
            if n is None or n < 0:
                return self._core.read_all()
            return self._core.read(n)
        except BaseException as e:  # latch and re-raise
            self._sticky = e
            raise

    def read1(self) -> int:
        """Single-byte read: -1 at end of stream (java-style, for parity)."""
        b = self.read(1)
        return b[0] if b else -1

    @property
    def is_done(self) -> bool:
        return self._core.is_done

    def detach(self) -> io.BufferedReader | io.BytesIO:
        """End DEFLATE reading exactly at the payload boundary.

        Returns a stream positioned at the first byte after the compressed
        data: over-read buffered bytes are replayed first, then the
        underlying source continues. Only valid once the stream is done.
        """
        if not self._end_exactly:
            raise ValueError("detach requires end_exactly=True")
        if self._sticky is not None:
            raise self._sticky
        tail = self._core.detach_tail()
        return _ChainedReader(tail, self._source)

    def close(self) -> None:
        self._closed = True


class _ChainedReader:
    """read(n) from a byte prefix, then from an underlying source."""

    def __init__(self, prefix: bytes, source):
        self._prefix = prefix
        self._pos = 0
        self._source = source

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            out = self._prefix[self._pos :] + (self._source.read() or b"")
            self._pos = len(self._prefix)
            return out
        out = b""
        if self._pos < len(self._prefix):
            out = self._prefix[self._pos : self._pos + n]
            self._pos += len(out)
        if len(out) < n:
            out += self._source.read(n - len(out)) or b""
        return out
