"""Front door of the port (counterpart of ``tpu_deflate.engine``).

``engine="cuda"`` runs the kernels on ``torch.device("cuda")`` and raises
where no CUDA device exists: it never carries on on the CPU or in the C
core. ``decompress`` is the member-parallel device decode; ``compress`` is
the reference's ``compress(engine="tpu")``: the member-parallel device
encode at efforts 0-3, the continuous-history one at efforts >= 4, and
the leading metadata member. Both take ``mesh=`` (``dist.mesh.CodecMesh``),
or build it from a ``FrameworkConfig`` whose ``MeshConfig`` is not the
trivial 1x1 one, and then cut their lanes over its devices.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from .config import DecoderConfig, EncoderConfig


def _cuda(engine: str) -> torch.device:
    if engine != "cuda":
        raise ValueError(f"engine={engine!r}: the port has only engine='cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("engine='cuda' needs a CUDA device, and none is available")
    return torch.device("cuda")


def _mesh(mesh, config, device: torch.device):
    """The call's mesh: ``mesh``, or the one ``config.mesh`` (a MeshConfig)
    describes over ``device``'s type (the first CUDA devices, or ``device``
    repeated); None for none. Its devices must be of ``device``'s type."""
    if mesh is None:
        mcfg = getattr(config, "mesh", None)
        if mcfg is None:
            return None
        from .dist.mesh import mesh_from_config

        n = mcfg.hosts * mcfg.chips_per_host
        mesh = mesh_from_config(mcfg, devices=None if device.type == "cuda" else [device] * n)
        if mesh is None:
            return None
    types = sorted({d.type for d in mesh.devices.reshape(-1)})
    if types != [device.type]:
        raise ValueError(f"the call runs on {device.type} devices, the mesh holds {types}")
    return mesh


def compress(data: bytes, *, engine: str = "cuda", effort: int | None = None, metadata=None,
             config=None, mesh=None) -> bytes:
    """Compress to gzip on the GPU, byte-identical to the JAX package's
    ``compress(engine="tpu")`` at the same effort (where its faults F1, F2
    and F11 do not fire). ``effort``: 0 and 1 greedy parse, 2 lazy, 3 lazy
    with the widened candidate set, each a TD-indexed member per 64 KiB;
    4 and 5 one member with continuous 32 KiB history across blocks of
    ``config.lookahead`` bytes, 5 with the deepest candidate set.
    ``config`` is any object with ``effort`` and ``lookahead`` (the port's
    EncoderConfig, or the JAX package's), or one holding such an object as
    ``.encoder``; an explicit ``effort`` wins over it. ``metadata`` (a
    ``format.gzip_meta.GzipMetadata``, or any record with its fields) rides
    on a leading empty member. ``mesh`` (or a non-trivial ``config.mesh``)
    cuts the continuous-history encode's lanes over the mesh at effort >= 4,
    byte-identical to the unsharded member (a mesh across ranks: every rank
    encodes the whole input over its own devices); below effort 4 it is
    ignored, as the reference's ``engine="tpu"`` ignores it."""
    device = _cuda(engine)
    cfg = EncoderConfig() if config is None else getattr(config, "encoder", config)
    effort = cfg.effort if effort is None else effort
    mesh = _mesh(mesh, config, device)
    if effort >= 4:
        from .codec.continuous import compress_continuous

        out = compress_continuous(data, device=device if mesh is None else None, mesh=mesh, effort=effort,
                                  block_data=cfg.lookahead)
    else:
        from .codec.encode import compress_members

        out = compress_members(data, device=device, effort=effort)
    return _prepend_metadata(out, metadata)


def _prepend_metadata(out: bytes, metadata) -> bytes:
    """Metadata rides on a leading empty member that still carries the TD
    size subfield, so the stream stays splittable by members (the
    reference's ``_prepend_metadata``)."""
    if metadata is None:
        return out
    from .codec.encode_np import TD_SUBFIELD
    from .format.gzip_meta import header_bytes
    from .kernels.checksum import crc32

    # A TD subfield (size patched below) after the metadata's own FEXTRA.
    extra = (metadata.extra_field or b"") + TD_SUBFIELD + (4).to_bytes(2, "little") + bytes(4)
    meta = replace(metadata, extra_field=extra)
    header = bytearray(header_bytes(meta))
    empty_payload = bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])  # final stored block, length 0
    trailer = crc32(b"").to_bytes(4, "little") + bytes(4)
    total = len(header) + len(empty_payload) + len(trailer)
    size_at = 12 + len(extra) - 4
    header[size_at : size_at + 4] = total.to_bytes(4, "little")
    if meta.has_header_crc:  # it covers every byte before it
        header[-2:] = (crc32(bytes(header[:-2])) & 0xFFFF).to_bytes(2, "little")
    return bytes(header) + empty_payload + trailer + out


def decompress(data: bytes, *, engine: str = "cuda", config=None, mesh=None) -> bytes:
    """Decompress gzip. ``config`` is any object with ``verify_crc``,
    ``lane_batch`` and ``device_resolve`` (the port's DecoderConfig, or the
    JAX package's), or one holding such an object as ``.decoder``. With
    ``device_resolve="auto"`` (the default) or "on", every Huffman member
    resolves and is CRC-checked on the card: single-block members of at
    most 64 KiB on the main path, the rest in chained 64 KiB tiles (the
    JAX package keeps these on its host route unless "on"); "off" resolves
    on the host. ``mesh`` (or a non-trivial ``config.mesh``) cuts the lanes
    of every device stage over the mesh's devices, with the same output,
    routes and Reason (the reference's mesh path resolves on the host)."""
    device = _cuda(engine)
    cfg = DecoderConfig() if config is None else getattr(config, "decoder", config)
    mesh = _mesh(mesh, config, device)
    from .codec.decode_v2 import gzip_decompress_v2

    return gzip_decompress_v2(
        data,
        device=device if mesh is None else None,
        mesh=mesh,
        verify_crc=cfg.verify_crc,
        lane_batch=cfg.lane_batch,
        device_resolve=cfg.device_resolve,
    )
