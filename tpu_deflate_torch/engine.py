"""Front door of the port (counterpart of ``tpu_deflate.engine``).

``engine="cuda"`` runs the kernels on ``torch.device("cuda")`` and raises
where no CUDA device exists: it never carries on on the CPU or in the C
core. ``decompress`` is the member-parallel device decode; ``compress`` is
the member-parallel device encode at efforts 0-3 (the reference's
``compress(engine="tpu")`` below effort 4).
"""

from __future__ import annotations

import torch

from .config import DecoderConfig


def _cuda(engine: str) -> torch.device:
    if engine != "cuda":
        raise ValueError(f"engine={engine!r}: the port has only engine='cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("engine='cuda' needs a CUDA device, and none is available")
    return torch.device("cuda")


def compress(data: bytes, *, engine: str = "cuda", effort: int = 2, metadata=None) -> bytes:
    """Compress to the TD-indexed multi-member gzip profile on the GPU.
    ``effort``: 0 and 1 greedy parse, 2 lazy, 3 lazy with the widened
    candidate set; byte-identical to the JAX package's
    ``compress(engine="tpu")`` at the same effort."""
    if effort >= 4:
        raise NotImplementedError(
            f"effort={effort}: the continuous-history device encode is not ported yet "
            "(ROADMAP queue 1 item 11)"
        )
    if metadata is not None:
        raise NotImplementedError(
            "metadata=: the leading metadata member is not ported yet (ROADMAP queue 1 item 13)"
        )
    device = _cuda(engine)
    from .codec.encode import compress_members

    return compress_members(data, device=device, effort=effort)


def decompress(data: bytes, *, engine: str = "cuda", config=None) -> bytes:
    """Decompress gzip. ``config`` is any object with ``verify_crc``,
    ``lane_batch`` and ``device_resolve`` (the port's DecoderConfig, or the
    JAX package's), or one holding such an object as ``.decoder``. With
    ``device_resolve="auto"`` (the default) or "on", every Huffman member
    resolves and is CRC-checked on the card: single-block members of at
    most 64 KiB on the main path, the rest in chained 64 KiB tiles (the
    JAX package keeps these on its host route unless "on"); "off" resolves
    on the host."""
    device = _cuda(engine)
    cfg = DecoderConfig() if config is None else getattr(config, "decoder", config)
    from .codec.decode_v2 import gzip_decompress_v2

    return gzip_decompress_v2(
        data,
        device=device,
        verify_crc=cfg.verify_crc,
        lane_batch=cfg.lane_batch,
        device_resolve=cfg.device_resolve,
    )
