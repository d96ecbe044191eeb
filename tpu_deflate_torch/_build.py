"""Build and load the port's CUDA kernels, and the plumbing their wrappers
share.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, in ``_kernels_build/`` beside this file, and is
cached by a hash of the sources and flags, so a fresh checkout builds
everything on its first kernel launch and later processes reuse the
library. A failed build raises with the compiler's output; what ``ptxas``
reports per kernel (registers, shared memory, spills) is kept in
``_kernels_build/<library>.log``.

Pointers and the CUDA stream cross the boundary as ``c_void_p`` (Python
ints from ``tensor.data_ptr()`` and ``torch.cuda.current_stream()
.cuda_stream``); every C entry point returns ``cudaGetLastError()``.

Each wrapper runs its kernel on CUDA tensors and the plain PyTorch
version beside it on CPU tensors; a CUDA tensor never reaches a plain
version. ``LAUNCHES`` (decode kernels and the lane CRC) and
``ENCODE_LAUNCHES`` (encoder kernels) count kernel launches per wrapper
(plain-version calls do not count).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_kernels_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (all return cudaError_t as int).
SIGNATURES = {
    "td_stage_a_tables": [_P, _P, _I, _P],
    "td_stage_a": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "td_stage_b": [_P, _P, _I, _I, _P],
    "td_stage_dc": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "td_compact": [_P, _P, _P, _P, _I, _I, _I, _P],
    "td_compact_occupancy": [_P],
    "td_expand": [_P, _P, _P, _P, _I, _I, _P],
    "td_sweep": [_P, _P, _P, _P, _P, _I, _P],
    "td_sweep_occupancy": [_P],
    "td_crc32_lanes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "td_parse_transfers": [_P, _P, _I, _I, _P],
    "td_parse_replay": [_P, _P, _P, _I, _I, _P],
    "td_emit_body": [_P] * 13 + [_I, _I, _P],
}

# Kernel launches per wrapper since process start (or the last reset): the
# decode's kernels and the lane CRC, then the encoder's kernels. Module
# state shared by every caller in the process; not thread-safe: calls on
# several threads count each other's launches, and so does
# decode_v2.LAST_DECODE_STATS["launches"], which is taken from LAUNCHES by
# difference.
LAUNCHES = {
    "stage_a_tables": 0, "stage_a": 0, "stage_b": 0, "stage_dc": 0, "compact_flat": 0,
    "compact_any": 0, "expand": 0, "sweep": 0, "crc32_lanes": 0,
}
ENCODE_LAUNCHES = {"parse_transfers": 0, "parse_replay": 0, "emit_body": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for counts in (LAUNCHES, ENCODE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def all_launches() -> dict:
    """Both launch counts as one dict (a copy)."""
    return {**LAUNCHES, **ENCODE_LAUNCHES}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtd_kernels_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build() -> str:
    """Compile the kernels if no library for the current sources exists
    (one nvcc per source, in parallel, then one link); returns the
    library's path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{so}.{os.getpid()}"
    nvcc = nvcc_path()
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(s)}.o" for s in cus]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs))
    ]
    logs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{tag}.tmp"
    logs.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]))
    for o in objs:
        os.remove(o)
    with open(f"{so[:-3]}.log", "w") as f:
        f.write("\n".join(logs))
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# Wrapper plumbing
# ---------------------------------------------------------------------------


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    require(isinstance(t, torch.Tensor), f"{name}: expected a tensor")
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    require(t.dim() == ndim, f"{name}: shape {tuple(t.shape)}, expected {ndim} dims")
    require(t.is_contiguous(), f"{name}: must be contiguous")
    require(t.numel() > 0, f"{name}: empty")


def on_card(*tensors: torch.Tensor) -> bool:
    """True for the kernel (all tensors on one CUDA device), False for the
    plain version (all on the CPU); raises otherwise."""
    dev = tensors[0].device
    require(all(t.device == dev for t in tensors), "inputs on different devices")
    if dev.type == "cpu":
        return False
    require(dev.type == "cuda", f"unsupported device {dev}")
    return True


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
