"""Error taxonomy of the port (a copy of ``tpu_deflate.format.errors``).

The 19-value ``Reason`` enum keeps the reference's codes and order, so a
Reason raised by the port and one raised by the JAX package compare equal
by ``.name`` and by value. ``Reason`` and ``DataFormatError`` are the
port's own classes: ``except DataFormatError`` here does not catch the JAX
package's error, and the other way round.
"""

from __future__ import annotations

import enum


class Reason(enum.IntEnum):
    """Why a DEFLATE/gzip/zlib stream was rejected.

    Kernels report failures as int32 codes ``reason + 1`` (0 = ok),
    converted back with :func:`code_to_reason`.
    """

    # --- raw DEFLATE (RFC 1951) ---
    UNEXPECTED_END_OF_STREAM = 0
    RESERVED_BLOCK_TYPE = 1
    UNCOMPRESSED_BLOCK_LENGTH_MISMATCH = 2
    HUFFMAN_CODE_UNDER_FULL = 3
    HUFFMAN_CODE_OVER_FULL = 4
    NO_PREVIOUS_CODE_LENGTH_TO_COPY = 5
    CODE_LENGTH_CODE_OVER_FULL = 6
    END_OF_BLOCK_CODE_ZERO_LENGTH = 7
    RESERVED_LENGTH_SYMBOL = 8
    RESERVED_DISTANCE_SYMBOL = 9
    LENGTH_ENCOUNTERED_WITH_EMPTY_DISTANCE_CODE = 10
    COPY_FROM_BEFORE_DICTIONARY_START = 11

    # --- containers (RFC 1950 / RFC 1952 shared) ---
    HEADER_CHECKSUM_MISMATCH = 12
    UNSUPPORTED_COMPRESSION_METHOD = 13
    DECOMPRESSED_CHECKSUM_MISMATCH = 14
    DECOMPRESSED_SIZE_MISMATCH = 15

    # --- gzip header (RFC 1952) ---
    GZIP_INVALID_MAGIC_NUMBER = 16
    GZIP_RESERVED_FLAGS_SET = 17
    GZIP_UNSUPPORTED_OPERATING_SYSTEM = 18


class DataFormatError(ValueError):
    """A stream violates RFC 1951/1950/1952; carries a ``Reason``."""

    def __init__(self, reason: Reason, message: str):
        super().__init__(message)
        self.reason = Reason(reason)

    @staticmethod
    def unexpected_end() -> "DataFormatError":
        return DataFormatError(Reason.UNEXPECTED_END_OF_STREAM, "Unexpected end of stream")


def raise_unexpected_end():
    raise DataFormatError.unexpected_end()


class OutputCapacityError(RuntimeError):
    """A native decode needs a larger output buffer (internal signal).

    Not a ``DataFormatError``: grow-and-retry loops catch exactly this and
    let real format errors propagate.
    """


OK_CODE = 0  # kernel error code meaning "no error"


def reason_to_code(reason: Reason) -> int:
    """Map a Reason to the nonzero int32 code kernels report."""
    return int(reason) + 1


def code_to_reason(code: int) -> Reason:
    """Inverse of :func:`reason_to_code` (code must be nonzero)."""
    if code == OK_CODE:
        raise ValueError("code 0 means success, not an error")
    return Reason(code - 1)


def check_device_error(code: int, context: str = "") -> None:
    """Raise DataFormatError if a kernel-reported error code is set."""
    code = int(code)
    if code != OK_CODE:
        reason = code_to_reason(code)
        suffix = f" ({context})" if context else ""
        raise DataFormatError(reason, f"{reason.name}{suffix}")
