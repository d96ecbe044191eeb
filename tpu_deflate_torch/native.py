"""The port's ctypes binding of the shared C core ``native/deflate_core.c``.

The C source lives at the repository root and is shared with the JAX
package, which binds it on its own. This module compiles it with ``cc``
into ``_kernels_build/`` beside the package (cached by a hash of the
source and flags; git-ignored) at first use, and binds only what the port
calls: the token resolve and CRC-32 of the host-resolve route, the serial
inflate of the fallback for streams without a member index, the member
encoder that writes the profile streams the port reads, and the block
encoder of the sharded continuous-history encode
(``dist.sharded.sharded_continuous_compress``). A failed
build raises with the compiler's output: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading

import numpy as np

from .format.errors import DataFormatError, OutputCapacityError, Reason, check_device_error
from .format.gzip_meta import read_gzip_header

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "native", "deflate_core.c")
BUILD_DIR = os.path.join(_HERE, "_kernels_build")
CC_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")
_TD_OUTPUT_OVERFLOW = 100  # td_inflate / td_resolve_tokens: out_cap too small

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_SZP = ctypes.POINTER(ctypes.c_size_t)
# C entry point -> (restype, argtypes).
SIGNATURES = {
    "td_crc32": (ctypes.c_uint32, [ctypes.c_char_p, _SZ, ctypes.c_uint32]),
    "td_inflate": (ctypes.c_int, [ctypes.c_char_p, _SZ, _P, _SZ, _SZP, _SZP]),
    "td_resolve_tokens": (ctypes.c_int, [_P, _SZ, _P, _SZ, _SZP]),
    "td_deflate_members": (
        _SZ,
        [ctypes.c_char_p, _SZ, _SZ, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _SZ],
    ),
    "td_deflate_block": (
        _SZ,
        [ctypes.c_char_p, _SZ, _SZ, _P, _SZ, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
         ctypes.c_int, ctypes.c_int],
    ),
}

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdeflate_core_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the C core if no library for the current source exists."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["cc", *CC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The C core, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def crc32(data: bytes, value: int = 0) -> int:
    return int(load().td_crc32(data, len(data), value & 0xFFFFFFFF))


def inflate_raw(payload: bytes, out_cap: int) -> tuple[bytes, int]:
    """Decode one complete raw DEFLATE stream; returns (bytes, input bytes
    consumed). Raises DataFormatError, or OutputCapacityError when the
    output does not fit out_cap."""
    out = ctypes.create_string_buffer(max(out_cap, 1))
    out_len = ctypes.c_size_t(0)
    consumed = ctypes.c_size_t(0)
    rc = load().td_inflate(
        payload, len(payload), out, out_cap, ctypes.byref(out_len), ctypes.byref(consumed)
    )
    if rc == _TD_OUTPUT_OVERFLOW:
        raise OutputCapacityError("output capacity too small")
    check_device_error(rc)
    return out.raw[: out_len.value], consumed.value


def resolve_tokens(tokens: np.ndarray, out_cap: int) -> bytes:
    """Expand an int32 token stream (literal byte | bit 26, run << 16,
    dist - 1) to bytes; raises like :func:`inflate_raw`."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    out = ctypes.create_string_buffer(max(out_cap, 1))
    out_len = ctypes.c_size_t(0)
    rc = load().td_resolve_tokens(
        tokens.ctypes.data_as(ctypes.c_void_p), tokens.size, out, out_cap, ctypes.byref(out_len)
    )
    if rc == _TD_OUTPUT_OVERFLOW:
        raise OutputCapacityError("output capacity too small")
    check_device_error(rc)
    return out.raw[: out_len.value]


def gzip_decompress_serial(data: bytes) -> bytes:
    """Decode a gzip stream member after member with the C core's inflate
    (the stream needs no member index): header, payload, then the trailer's
    CRC-32 and size, in the host decoder's order."""
    if not data:
        raise DataFormatError.unexpected_end()
    out_parts = []
    stream = io.BytesIO(data)
    while stream.tell() < len(data):
        read_gzip_header(stream)
        payload_start = stream.tell()
        payload = data[payload_start:]
        cap = max(8 * len(payload) + 1024, 1 << 20)
        while True:
            try:
                out, consumed = inflate_raw(payload, cap)
                break
            except OutputCapacityError:  # grow and retry; format errors propagate
                cap *= 4
        trailer = payload[consumed : consumed + 8]
        if len(trailer) < 8:
            raise DataFormatError.unexpected_end()
        if crc32(out) != int.from_bytes(trailer[:4], "little"):
            raise DataFormatError(
                Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
            )
        if (len(out) & 0xFFFFFFFF) != int.from_bytes(trailer[4:8], "little"):
            raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "Decompressed size mismatch")
        out_parts.append(out)
        stream.seek(payload_start + consumed + 8)
    return b"".join(out_parts)


# The profile's empty stream: one member holding a final stored empty block.
_EMPTY_MEMBER = (
    b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x08\x00TD\x04\x00"
    + (33).to_bytes(4, "little")
    + b"\x01\x00\x00\xff\xff"
    + bytes(8)
)


def compress_members_native(
    data: bytes, *, member_data: int = 64 * 1024, max_code_len: int = 12, max_chain: int = 32
) -> bytes:
    """Encode ``data`` as the TD-indexed multi-member profile stream (one
    gzip member per ``member_data`` bytes) on all host cores."""
    if not data:
        return _EMPTY_MEMBER
    n = len(data)
    nm = (n + member_data - 1) // member_data
    cap = n + n // 8 + nm * (28 + 1024) + 64
    out = ctypes.create_string_buffer(cap)
    got = int(
        load().td_deflate_members(
            data, n, member_data, max_code_len, max_chain, os.cpu_count() or 2, out, cap
        )
    )
    if got == 0:
        raise RuntimeError("native member encoder failed")
    return out.raw[:got]


def deflate_block(buf: bytes, hist_len: int, n: int, final: bool, start_bit: int, seed_byte: int,
                  max_code_len: int, max_chain: int) -> tuple[bytes, int]:
    """Encode ``buf[hist_len : hist_len + n]`` as one DEFLATE block whose
    matches may reach into the ``hist_len`` bytes before it, starting at
    bit ``start_bit`` of a first byte that already holds ``seed_byte``'s
    low bits. Returns (the output buffer, the bits written, counted from
    bit 0 of its first byte)."""
    cap = n + n // 4 + 2048
    out = ctypes.create_string_buffer(cap)
    bits = int(load().td_deflate_block(buf, hist_len, n, out, cap, int(final), start_bit, seed_byte,
                                       max_code_len, max_chain))
    if bits == 0:
        raise RuntimeError("native deflate_block failed")
    return out.raw, bits
