"""RFC 1950 zlib stream header as an immutable record (a copy of
``tpu_deflate.format.zlib_meta``): the field set, the FCHECK mod-31
validation, the preset-dictionary id and the compression-level enum of the
reference's ``ZlibMetadata``."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .errors import DataFormatError, Reason

_CHECKSUM_MODULUS = 31


class CompressionMethod(enum.Enum):
    DEFLATE = 8
    RESERVED = 15


class CompressionLevel(enum.IntEnum):
    FASTEST = 0
    FAST = 1
    DEFAULT = 2
    MAXIMUM = 3


@dataclass(frozen=True)
class ZlibMetadata:
    compression_method: CompressionMethod = CompressionMethod.DEFLATE
    compression_info: int = 7  # log2(window)-8 for DEFLATE; uint4
    preset_dictionary: int | None = None  # Adler-32 of the dictionary
    compression_level: CompressionLevel = CompressionLevel.DEFAULT

    def __post_init__(self):
        if self.compression_info >> 4 != 0 or (
            self.compression_method == CompressionMethod.DEFLATE
            and self.compression_info > 7
        ):
            raise ValueError("Invalid compression info value")
        if not isinstance(self.compression_level, CompressionLevel):
            raise TypeError("compression_level")

    @staticmethod
    def read(source) -> "ZlibMetadata":
        head = source.read(2)
        if len(head) < 2:
            raise DataFormatError.unexpected_end()
        cmf, flg = head[0], head[1]
        if (cmf << 8 | flg) % _CHECKSUM_MODULUS != 0:
            raise DataFormatError(Reason.HEADER_CHECKSUM_MISMATCH, "Header checksum mismatch")
        method_int = cmf & 0xF
        if method_int == 8:
            method = CompressionMethod.DEFLATE
        elif method_int == 15:
            method = CompressionMethod.RESERVED
        else:
            raise DataFormatError(
                Reason.UNSUPPORTED_COMPRESSION_METHOD,
                f"Unsupported compression method: {method_int}",
            )
        comp_info = cmf >> 4
        preset = None
        if (flg >> 5) & 1:
            raw = source.read(4)
            if len(raw) < 4:
                raise DataFormatError.unexpected_end()
            preset = int.from_bytes(raw, "big")
        level = CompressionLevel(flg >> 6)
        return ZlibMetadata(method, comp_info, preset, level)

    def to_bytes(self) -> bytes:
        cmf = self.compression_method.value | (self.compression_info << 4)
        flg = ((1 if self.preset_dictionary is not None else 0) << 5) | (
            self.compression_level.value << 6
        )
        flg |= (_CHECKSUM_MODULUS - (cmf << 8 | flg) % _CHECKSUM_MODULUS) % _CHECKSUM_MODULUS
        out = bytes([cmf, flg])
        if self.preset_dictionary is not None:
            out += self.preset_dictionary.to_bytes(4, "big")
        return out

    def write(self, sink) -> None:
        sink.write(self.to_bytes())


DEFAULT = ZlibMetadata()
