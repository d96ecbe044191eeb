"""The benchmark's writer of member-profile decode inputs: the frozen encoder
in this folder (``deflate_core.c``), built with ``cc`` into
``portbench/_build/`` at first use and bound with ctypes.

:func:`members` writes the TD member profile: one gzip member per
``member_bytes`` of input, each one final block (or stored blocks where
that is smaller), code lengths capped, the member's size in the ``TD``
FEXTRA subfield; on all host cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "deflate_core.c")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
CC_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")

_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbench_core_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The frozen encoder, compiled once per source into a fixed directory."""
    global _lib
    if _lib is None:
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(["cc", *CC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"cc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        sz, p = ctypes.c_size_t, ctypes.c_void_p
        lib.td_deflate_members.restype = sz
        lib.td_deflate_members.argtypes = [p, sz, sz, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, sz]
        _lib = lib
    return _lib


def members(data: np.ndarray, *, member_bytes: int, max_code_len: int, max_chain: int) -> bytes:
    """The member profile stream of ``data`` (uint8, contiguous)."""
    data = np.ascontiguousarray(data, np.uint8)
    n = data.size
    nm = -(-n // member_bytes)
    cap = n + n // 8 + nm * (28 + 1024) + 64
    out = np.empty(cap, np.uint8)
    got = load().td_deflate_members(data.ctypes.data, n, member_bytes, max_code_len, max_chain,
                                    os.cpu_count() or 2, out.ctypes.data, cap)
    if got == 0:
        raise RuntimeError("td_deflate_members failed")
    return out[:got].tobytes()


def member_header(total: int) -> bytes:
    """gzip header with FEXTRA holding the ``TD`` subfield: the member's size."""
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + (8).to_bytes(2, "little") + b"TD"
            + (4).to_bytes(2, "little") + total.to_bytes(4, "little"))
