"""Encode, decode and mesh knobs of the port (the device fields of
``tpu_deflate.config``: ``EncoderConfig``, ``DecoderConfig``, ``MeshConfig``
and ``FrameworkConfig``)."""

from __future__ import annotations

from dataclasses import dataclass, field


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


@dataclass(frozen=True)
class MeshConfig:
    """Topology of the device mesh (``dist.mesh.mesh_from_config``): a 1-D
    mesh over ``chips_per_host`` devices, or with ``hosts`` > 1 the 2-D
    (host, data) pod mesh."""

    data_axis: str = "data"
    host_axis: str = "host"
    hosts: int = 1
    chips_per_host: int = 1


@dataclass(frozen=True)
class FrameworkConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


DEFAULT = FrameworkConfig()  # the trivial 1x1 mesh: no mesh
