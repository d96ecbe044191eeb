"""Decode front door of the port (counterpart of ``tpu_deflate.engine``).

``engine="cuda"`` decodes with the kernels on ``torch.device("cuda")``
and raises where no CUDA device exists: it never carries on on the CPU.
Encoding is not ported yet; the shared C core's member encoder
(``tpu_deflate_torch.native.compress_members_native``) writes the streams.
"""

from __future__ import annotations

import torch

from .config import DecoderConfig


def decompress(data: bytes, *, engine: str = "cuda", config=None) -> bytes:
    """Decompress gzip. ``config`` is any object with ``verify_crc``,
    ``lane_batch`` and ``device_resolve`` (the port's DecoderConfig, or the
    JAX package's), or one holding such an object as ``.decoder``."""
    if engine != "cuda":
        raise ValueError(f"engine={engine!r}: the port has only engine='cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("engine='cuda' needs a CUDA device, and none is available")
    cfg = DecoderConfig() if config is None else getattr(config, "decoder", config)
    from .codec.decode_v2 import gzip_decompress_v2

    return gzip_decompress_v2(
        data,
        device=torch.device("cuda"),
        verify_crc=cfg.verify_crc,
        lane_batch=cfg.lane_batch,
        device_resolve=cfg.device_resolve,
    )
