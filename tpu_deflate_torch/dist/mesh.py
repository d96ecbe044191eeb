"""Device mesh of the port (counterpart of ``tpu_deflate.dist.mesh``).

The reference shards the lane (member) axis of its batched codec kernels
over a ``jax.sharding.Mesh``. The port keeps its single-controller model:
a :class:`CodecMesh` is a 1-D or 2-D array of ``torch.device`` with axis
names, and one process drives every device of it. Lanes shard over the
product of the named axes in contiguous chunks, in lane order: shard k of
n holds lanes [k L / n, (k + 1) L / n), and L is padded to a multiple of n
(:func:`pad_lanes`).

A mesh may list a device more than once: ``make_codec_mesh(devices=[cpu]
* 8)`` is an 8-shard mesh on the CPU, ``[cuda] * 4`` a 4-shard mesh on one
card. Each shard then runs its kernels on that device in turn; the output
is the same as on distinct devices.

Across processes (:func:`init_distributed`, ``torch.distributed``), the
``host`` axis of a pod mesh is the ranks: row r of the mesh is rank r's
local devices, and each rank drives only its own row. The functions of
``dist.sharded`` then exchange data with ``torch.distributed`` calls
(NCCL between CUDA devices, gloo on the CPU) where within one process they
copy between devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist


def init_distributed(
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
) -> bool:
    """Bring up ``torch.distributed`` (``init_process_group``).

    Gated as the reference's ``jax.distributed.initialize``: it runs only
    when a coordinator address is given, or set in ``TD_COORDINATOR`` or
    ``JAX_COORDINATOR_ADDRESS`` (with ``TD_NUM_PROCESSES`` and
    ``TD_PROCESS_ID``), so a single-process run never waits on one. The
    address is ``host:port`` or a ``tcp://``/``file://`` URL. ``device``
    ("cuda" or "cpu"; default "cuda" where a card exists) picks the backend
    the mesh's devices need: NCCL for CUDA, gloo on the CPU. Returns True
    iff the process group is (now) up. Idempotent.
    """
    if tdist.is_initialized():
        return True
    address = (
        coordinator_address
        or os.environ.get("TD_COORDINATOR")
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if not address:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("TD_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("TD_PROCESS_ID", "0"))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if "://" not in address:
        address = f"tcp://{address}"
    tdist.init_process_group(
        backend="nccl" if device == "cuda" else "gloo",
        init_method=address,
        world_size=num_processes,
        rank=process_id,
    )
    return True


@dataclass(frozen=True, eq=False)
class CodecMesh:
    """Devices with axis names. ``rank_axis`` names the axis that is the
    ranks of the process group (None: the mesh lives in this process)."""

    devices: np.ndarray  # object array of torch.device, one dimension per axis name
    axis_names: tuple[str, ...]
    rank_axis: str | None = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def rank(self) -> int:
        return tdist.get_rank() if self.rank_axis else 0

    @property
    def world(self) -> int:
        return tdist.get_world_size() if self.rank_axis else 1

    def local(self) -> "CodecMesh":
        """This process's part: the mesh itself, or for a mesh across
        ranks the row of this rank over the other axes."""
        if self.rank_axis is None:
            return self
        i = self.axis_names.index(self.rank_axis)
        names = tuple(a for a in self.axis_names if a != self.rank_axis)
        return CodecMesh(np.take(self.devices, self.rank, axis=i), names)


def _device_array(devs: list, shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return arr.reshape(shape)


def _cuda_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("a mesh of CUDA devices needs a CUDA device, and none is available; "
                           "pass devices= for another device")
    return [torch.device("cuda", i) for i in range(n)]


def _require_one_type(devs: list) -> None:
    types = {torch.device(d).type for d in devs}
    if len(types) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")


def make_codec_mesh(n_devices: int | None = None, *, axis: str = "data", devices=None) -> CodecMesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (default: all),
    or over ``devices`` (a list, which may repeat a device: ``[cuda] * 4``
    is four shards on one card)."""
    devs = list(_cuda_devices() if devices is None else devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} available")
        devs = devs[:n_devices]
    _require_one_type(devs)
    return CodecMesh(_device_array(devs, (len(devs),)), (axis,))


def make_pod_mesh(hosts: int, chips_per_host: int, *, devices=None, host_axis: str = "host",
                  data_axis: str = "data") -> CodecMesh:
    """2-D (host, data) mesh. With a process group of ``hosts`` ranks up,
    the host axis is the ranks: row r is rank r's first ``chips_per_host``
    devices (of ``devices`` where given, else its CUDA devices), and each
    rank holds only its own row. Otherwise the mesh lives in this process
    over the first ``hosts * chips_per_host`` devices."""
    if tdist.is_initialized() and tdist.get_world_size() == hosts:
        local = list(_cuda_devices() if devices is None else devices)[:chips_per_host]
        if len(local) < chips_per_host:
            raise ValueError(f"{chips_per_host} devices a host asked for, {len(local)} available")
        _require_one_type(local)
        return CodecMesh(_device_array(local * hosts, (hosts, chips_per_host)), (host_axis, data_axis),
                         rank_axis=host_axis)
    devs = list(_cuda_devices() if devices is None else devices)[: hosts * chips_per_host]
    if len(devs) < hosts * chips_per_host:
        raise ValueError(f"{hosts * chips_per_host} devices asked for, {len(devs)} available")
    _require_one_type(devs)
    return CodecMesh(_device_array(devs, (hosts, chips_per_host)), (host_axis, data_axis))


def mesh_from_config(cfg, *, devices=None) -> CodecMesh | None:
    """The mesh a :class:`~tpu_deflate_torch.config.MeshConfig` describes:
    None for the trivial 1x1 topology, the 2-D (host, data) pod mesh for
    hosts > 1, else a 1-D mesh over ``chips_per_host`` devices under the
    configured axis name."""
    if cfg.hosts <= 1 and cfg.chips_per_host <= 1:
        return None
    if cfg.hosts > 1:
        return make_pod_mesh(cfg.hosts, cfg.chips_per_host, devices=devices, host_axis=cfg.host_axis,
                             data_axis=cfg.data_axis)
    return make_codec_mesh(cfg.chips_per_host, axis=cfg.data_axis, devices=devices)


@dataclass(frozen=True, eq=False)
class LaneSharding:
    """The lane axis cut over ``n`` shards; this process holds shards
    ``first`` .. ``first + len(devices) - 1``, on ``devices``. With
    ``across_ranks`` the other shards are the other ranks'."""

    devices: tuple[torch.device, ...]
    n: int
    first: int
    across_ranks: bool

    @classmethod
    def one(cls, device: torch.device) -> "LaneSharding":
        """The lane axis whole on one device."""
        return cls((torch.device(device),), 1, 0, False)

    def bounds(self, lanes: int, real: int | None = None) -> list[tuple[int, int]]:
        """Lane range [a, b) of each local shard, in the order of
        ``devices``; ``lanes`` must divide by n (:func:`pad_lanes`). With
        ``real``, the shards that hold none of the first ``real`` lanes
        (padding only: the last ones) are left out."""
        if lanes % self.n:
            raise ValueError(f"{lanes} lanes do not divide over {self.n} shards (pad_lanes)")
        s = lanes // self.n
        real = lanes if real is None else real
        firsts = [(self.first + k) * s for k in range(len(self.devices))]
        return [(a, a + s) for a in firsts if a < real]

    def split(self, x) -> list[torch.Tensor]:
        """The local shards of x (a tensor or array, lanes leading), each
        on its device."""
        parts = []
        for dev, (a, b) in zip(self.devices, self.bounds(x.shape[0])):
            part = x[a:b]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            parts.append(part.to(dev))
        return parts

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """All n shards' results (equal shapes), concatenated in lane
        order on the first local device: copies within the process, an
        ``all_gather`` across ranks."""
        out = self.devices[0]
        local = torch.cat([p.to(out) for p in parts])
        if not self.across_ranks:
            return local
        block = local.to(comm_device(out)).contiguous()
        blocks = [torch.empty_like(block) for _ in range(tdist.get_world_size())]
        tdist.all_gather(blocks, block)
        return torch.cat(blocks).to(out)


def comm_device(dev: torch.device) -> torch.device:
    """Where a tensor of ``dev`` crosses ranks: ``dev`` under NCCL, the
    CPU under gloo."""
    return dev if tdist.get_backend() == "nccl" else torch.device("cpu")


def lane_sharding(mesh: CodecMesh, axis: str | tuple | None = "data") -> LaneSharding:
    """Shard the leading (lane) dimension over the named axes (None: all
    of the mesh's axes), in their order, major first; the mesh's other
    axes replicate (their index-0 devices compute, or across ranks each
    rank's own row). Across ranks the rank axis must come first."""
    names = mesh.axis_names if axis is None else ((axis,) if isinstance(axis, str) else tuple(axis))
    missing = [a for a in names if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not among the mesh's {mesh.axis_names}")
    picked = [mesh.axis_names.index(a) for a in names]
    sel = tuple(
        slice(None) if i in picked else (mesh.rank if a == mesh.rank_axis else 0)
        for i, a in enumerate(mesh.axis_names)
    )
    kept = sorted(picked)
    grid = np.transpose(mesh.devices[sel], [kept.index(i) for i in picked])
    flat = list(grid.reshape(-1))
    across = mesh.rank_axis in names
    if not across:
        return LaneSharding(tuple(flat), len(flat), 0, False)
    if names[0] != mesh.rank_axis:
        raise ValueError(f"across ranks the lanes shard over {mesh.rank_axis!r} first")
    per = len(flat) // mesh.world
    first = mesh.rank * per
    return LaneSharding(tuple(flat[first : first + per]), len(flat), first, True)


def replicated(mesh: CodecMesh) -> tuple[torch.device, ...]:
    """The distinct devices of this process's part of the mesh: where a
    replicated value keeps one copy each."""
    return tuple(dict.fromkeys(mesh.local().devices.reshape(-1)))


def pad_lanes(n_lanes: int, n_shards: int) -> int:
    """Lanes padded up so the lane axis divides evenly across shards."""
    return -(-n_lanes // n_shards) * n_shards
