"""gzip (RFC 1952) container streams (a copy of
``tpu_deflate.streams.gzip_stream``).

``GzipWriter``: header via the metadata record, running CRC-32 over the
plaintext, little-endian CRC32+ISIZE trailer on finish. ``GzipReader``:
header via the metadata record, raw-DEFLATE payload with the end-exactly
contract, trailer verify (DECOMPRESSED_CHECKSUM_MISMATCH /
DECOMPRESSED_SIZE_MISMATCH). With ``multi_member=True`` concatenated
members (RFC 1952 §2.2) decode to the concatenated plaintext; the bytes
the inflater read past a member are pushed back for the next header.
"""

from __future__ import annotations

from ..codec import deflate_encode as enc
from ..format.errors import DataFormatError, Reason, raise_unexpected_end
from ..format.gzip_meta import GzipMetadata
from ..kernels.checksum import crc32
from .deflater import Deflater
from .inflater import InflaterReader


class GzipWriter:
    """Single-member gzip compressor stream."""

    def __init__(
        self,
        sink,
        metadata: GzipMetadata | None = None,
        *,
        strategy: enc.Strategy | None = None,
        lookahead: int = 64 * 1024,
        history: int = 32 * 1024,
    ):
        self._sink = sink
        meta = metadata if metadata is not None else GzipMetadata()
        meta.write(sink)
        self._deflater = Deflater(
            sink, strategy=strategy, lookahead=lookahead, history=history
        )
        self._crc = 0
        self._length = 0
        self._finished = False

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("Stream already ended")
        self._deflater.write(data)
        self._crc = crc32(data, self._crc)
        self._length += len(data)
        return len(data)

    def finish(self) -> None:
        if self._finished:
            raise ValueError("Stream already ended")
        self._deflater.finish()
        trailer = self._crc.to_bytes(4, "little") + (
            self._length & 0xFFFFFFFF
        ).to_bytes(4, "little")
        self._sink.write(trailer)
        self._finished = True

    def close(self) -> None:
        if not self._finished:
            self.finish()


class GzipReader:
    """gzip decompressor stream with full trailer verification."""

    def __init__(self, source, *, multi_member: bool = False):
        self._source = source
        self._multi_member = multi_member
        self._metadata = GzipMetadata.read(source)
        self._inflater = InflaterReader(source, end_exactly=True)
        self._crc = 0
        self._length = 0
        self._eof = False

    @property
    def metadata(self) -> GzipMetadata:
        """Header metadata of the first (or current) member."""
        return self._metadata

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            want = (n - len(out)) if n >= 0 else (1 << 20)
            chunk = self._inflater.read(want)
            if chunk:
                out += chunk
                self._crc = crc32(chunk, self._crc)
                self._length += len(chunk)
                continue
            # Member finished: verify trailer.
            if self._eof:
                break
            tail = self._inflater.detach()
            trailer = tail.read(8)
            if len(trailer) < 8:
                raise_unexpected_end()
            expect_crc = int.from_bytes(trailer[:4], "little")
            expect_len = int.from_bytes(trailer[4:8], "little")
            if expect_crc != self._crc:
                raise DataFormatError(
                    Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
                )
            if expect_len != self._length & 0xFFFFFFFF:
                raise DataFormatError(
                    Reason.DECOMPRESSED_SIZE_MISMATCH, "Decompressed size mismatch"
                )
            if not self._multi_member:
                self._eof = True
                break
            # Look for another member.
            probe = tail.read(1)
            if not probe:
                self._eof = True
                break
            rest = _PushbackReader(probe, tail)
            self._metadata = GzipMetadata.read(rest)
            self._inflater = InflaterReader(rest, end_exactly=True)
            self._crc = 0
            self._length = 0
        return bytes(out)

    def close(self) -> None:
        self._inflater.close()


class _PushbackReader:
    def __init__(self, prefix: bytes, source):
        self._prefix = prefix
        self._source = source

    def read(self, n: int = -1) -> bytes:
        if self._prefix:
            if n is None or n < 0:
                out = self._prefix + (self._source.read() or b"")
                self._prefix = b""
                return out
            out = self._prefix[:n]
            self._prefix = self._prefix[len(out) :]
            if len(out) < n:
                out += self._source.read(n - len(out)) or b""
            return out
        return self._source.read(n)
