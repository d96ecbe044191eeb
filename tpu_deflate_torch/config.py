"""Encode and decode knobs of the port (the device fields of
``tpu_deflate.config.EncoderConfig`` and ``DecoderConfig``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EncoderConfig:
    effort: int = 2
    # bytes per block of the continuous-history encode (effort >= 4)
    lookahead: int = 64 * 1024


@dataclass(frozen=True)
class DecoderConfig:
    verify_crc: bool = True
    # members per device batch (capped at wave_prep.V2_LANE_BATCH)
    lane_batch: int = 256
    # LZ77 resolve and CRC-32 on the device for every Huffman member:
    # "auto" (when the decode device is CUDA), "on" (on any device, the
    # CPU with the plain versions) or "off" (host resolve)
    device_resolve: str = "auto"
