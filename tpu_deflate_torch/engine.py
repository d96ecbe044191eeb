"""Decode front door of the port (counterpart of ``tpu_deflate.engine``).

``engine="cuda"`` decodes with the wave kernels on ``torch.device("cuda")``
and raises where no CUDA device exists: it never carries on on the CPU.
Encoding is not ported yet; ``tpu_deflate.engine.compress`` (native or
host engines) writes the same streams.
"""

from __future__ import annotations

import torch

from tpu_deflate.engine import _decoder_cfg


def decompress(data: bytes, *, engine: str = "cuda", config=None) -> bytes:
    """Decompress gzip; ``config`` is a DecoderConfig or FrameworkConfig
    (verify_crc, lane_batch and device_resolve are read from it)."""
    if engine != "cuda":
        raise ValueError(f"engine={engine!r}: the port has only engine='cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("engine='cuda' needs a CUDA device, and none is available")
    cfg = _decoder_cfg(config)
    from .codec.decode_v2 import gzip_decompress_v2

    return gzip_decompress_v2(
        data,
        device=torch.device("cuda"),
        verify_crc=cfg.verify_crc,
        lane_batch=cfg.lane_batch,
        device_resolve=cfg.device_resolve,
    )
