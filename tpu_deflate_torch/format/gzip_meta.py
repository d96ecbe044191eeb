"""RFC 1952 member headers (trimmed copies of
``tpu_deflate.format.gzip_meta``): the header record and its writer, for
the metadata member the encoder can put first, and the reader, which the
decode uses only to find where the DEFLATE payload starts, so it
validates the fields with the reference's Reasons and returns nothing
else."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..kernels.checksum import crc32
from .errors import DataFormatError, Reason

MAGIC = 0x1F8B
_OS_UNKNOWN_WIRE = 0xFF
_OS_VALUES = 14  # RFC 1952 OS values 0..13, plus 0xFF


class OperatingSystem(enum.IntEnum):
    """RFC 1952 OS values 0-13, plus UNKNOWN, written as 0xFF."""

    FAT_FILESYSTEM = 0
    AMIGA = 1
    VMS = 2
    UNIX = 3
    VM_CMS = 4
    ATARI_TOS = 5
    HPFS_FILESYSTEM = 6
    MACINTOSH = 7
    Z_SYSTEM = 8
    CPM = 9
    TOPS_20 = 10
    NTFS_FILESYSTEM = 11
    QDOS = 12
    ACORN_RISCOS = 13
    UNKNOWN = 14


@dataclass(frozen=True)
class GzipMetadata:
    """The header fields of a gzip member, with the reference record's
    names, defaults and checks (the method is always DEFLATE)."""

    is_file_text: bool = False
    modification_time_unix_s: int | None = None  # None <=> wire value 0
    extra_flags: int = 0
    operating_system: OperatingSystem = OperatingSystem.UNKNOWN
    extra_field: bytes | None = None
    file_name: str | None = None
    comment: str | None = None
    has_header_crc: bool = False

    def __post_init__(self):
        if self.modification_time_unix_s == 0:
            raise ValueError("Modification timestamp is zero")
        if self.extra_flags >> 8 != 0:
            raise ValueError("Invalid extra flags value")
        if self.extra_field is not None and len(self.extra_field) > 0xFFFF:
            raise ValueError("Extra field too long")

    def to_bytes(self) -> bytes:
        return header_bytes(self)


def header_bytes(meta) -> bytes:
    """The wire header of ``meta``, any record with GzipMetadata's fields
    (the reference's too): magic, method (DEFLATE), flags, MTIME, XFL, OS,
    then the optional extra field, name, comment and header CRC-16."""
    out = bytearray(MAGIC.to_bytes(2, "big"))
    out.append(8)
    out.append((1 if meta.is_file_text else 0) | (2 if meta.has_header_crc else 0)
               | (4 if meta.extra_field is not None else 0) | (8 if meta.file_name is not None else 0)
               | (16 if meta.comment is not None else 0))
    out += ((meta.modification_time_unix_s or 0) & 0xFFFFFFFF).to_bytes(4, "little")
    out.append(meta.extra_flags)
    os_val = int(meta.operating_system)
    out.append(_OS_UNKNOWN_WIRE if os_val == _OS_VALUES else os_val)
    if meta.extra_field is not None:
        out += len(meta.extra_field).to_bytes(2, "little") + meta.extra_field
    if meta.file_name is not None:
        out += meta.file_name.encode("latin-1") + b"\x00"
    if meta.comment is not None:
        out += meta.comment.encode("latin-1") + b"\x00"
    if meta.has_header_crc:
        out += (crc32(bytes(out)) & 0xFFFF).to_bytes(2, "little")
    return bytes(out)


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
