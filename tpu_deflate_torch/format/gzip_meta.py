"""RFC 1952 member header reader (a copy of the checks of
``tpu_deflate.format.gzip_meta.GzipMetadata.read``): the port reads a
header only to find where the DEFLATE payload starts, so it validates the
fields with the reference's Reasons and returns nothing else."""

from __future__ import annotations

from ..kernels.checksum import crc32
from .errors import DataFormatError, Reason

MAGIC = 0x1F8B
_OS_UNKNOWN_WIRE = 0xFF
_OS_VALUES = 14  # RFC 1952 OS values 0..13, plus 0xFF


class _HeaderReader:
    """Byte reader that tracks a running CRC-32 of everything consumed."""

    def __init__(self, source):
        self._source = source
        self.crc = 0

    def read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._source.read(n - len(out))
            if not chunk:
                raise DataFormatError.unexpected_end()
            out += chunk
        self.crc = crc32(out, self.crc)
        return out

    def skip_until_nul(self) -> None:
        while self.read_exact(1) != b"\x00":
            pass


def read_gzip_header(source) -> None:
    """Consume one gzip member header from ``source`` (``read(n)->bytes``),
    leaving it at the first payload byte; raises DataFormatError with the
    reference's Reason on a bad header."""
    r = _HeaderReader(source)
    head = r.read_exact(10)
    if (head[0] << 8 | head[1]) != MAGIC:
        raise DataFormatError(Reason.GZIP_INVALID_MAGIC_NUMBER, "Invalid GZIP magic number")
    if head[2] != 8:
        raise DataFormatError(
            Reason.UNSUPPORTED_COMPRESSION_METHOD, f"Unsupported compression method: {head[2]}"
        )
    flags = head[3]
    if flags & 0xE0:
        raise DataFormatError(Reason.GZIP_RESERVED_FLAGS_SET, "Reserved flags are set")
    if head[9] >= _OS_VALUES and head[9] != _OS_UNKNOWN_WIRE:
        raise DataFormatError(
            Reason.GZIP_UNSUPPORTED_OPERATING_SYSTEM, "Unsupported operating system value"
        )
    if flags & 0x04:  # FEXTRA
        r.read_exact(int.from_bytes(r.read_exact(2), "little"))
    if flags & 0x08:  # FNAME
        r.skip_until_nul()
    if flags & 0x10:  # FCOMMENT
        r.skip_until_nul()
    if flags & 0x02:  # FHCRC
        expect = r.crc & 0xFFFF
        if int.from_bytes(r.read_exact(2), "little") != expect:
            raise DataFormatError(Reason.HEADER_CHECKSUM_MISMATCH, "Header CRC-16 mismatch")
