"""The device encoder's greedy/lazy parse in tiles (counterpart of
``tpu_deflate.codec.parse_pallas``): K8 parse transfers and K9 parse
replay, with ``host_entries`` between them.

The parse walks the token chain ``next[i] = i + step[i]`` (step = the
chosen match run, or 1 for a literal) from position 0. Each 512-position
tile gets a transfer map (K8): for every entry offset 0..255, the offset
at which a walk from there leaves the tile into the next one. The host
composes the maps tile by tile (``host_entries``) to find each tile's true
entry, and K9 replays the chain from it, marking the positions it visits.
Steps are capped at ``PARSE_MAX_STEP`` by the caller, so an exit offset
fits a byte and no chain skips a whole tile.

Each wrapper runs the CUDA kernel of ``csrc/parse.cu`` on CUDA tensors and
the plain PyTorch version beside it on CPU tensors (``_build.on_card``).
The plain versions keep the reference's lock-step form: every cursor
moves when the scan position reaches it (``cur += step`` where
``cur == pos``), which for steps >= 1 is the serial walk the kernels do.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._build import ENCODE_LAUNCHES

T_P = 512  # positions per tile
E_P = 256  # entry offsets tracked (> max step, so no tile is skipped)
PARSE_MAX_STEP = 250  # keeps exit offsets byte-sized


def step_tiles(step: torch.Tensor) -> torch.Tensor:
    """(L, S) steps -> (L, T_P, NT) tile-major layout (a view: the storage
    stays position-major, which is the layout the kernels read)."""
    L, S = step.shape
    return step.view(L, S // T_P, T_P).transpose(1, 2)


def _steps(tiles: torch.Tensor) -> torch.Tensor:
    """(L, T_P, NT) tiles -> contiguous (L, NT, T_P) steps (no copy for a
    ``step_tiles`` view)."""
    _build.require(isinstance(tiles, torch.Tensor), "tiles: expected a tensor")
    _build.require(tiles.dim() == 3 and tiles.shape[1] == T_P, f"tiles: shape {tuple(tiles.shape)}")
    steps = tiles.transpose(1, 2).contiguous()
    _build.check_tensor("tiles", steps, torch.int32, 3)
    return steps


def parse_transfers_plain(tiles: torch.Tensor) -> torch.Tensor:
    """Plain K8: tiles (L, T_P, NT) int32 -> transfers (L, NT, E_P) uint8,
    the exit offset into the next tile of a walk entering at each offset."""
    L, _T, NT = tiles.shape
    cur = torch.arange(E_P, dtype=torch.int32, device=tiles.device).expand(L, NT, E_P).clone()
    for pos in range(T_P):
        cur += torch.where(cur == pos, tiles[:, pos, :, None], 0)
    return ((cur - T_P) & 0xFF).to(torch.uint8)


def parse_transfers(tiles: torch.Tensor) -> torch.Tensor:
    """K8: tiles (L, T_P, NT) int32 -> transfers (L, NT, E_P) uint8."""
    steps = _steps(tiles)
    if not _build.on_card(steps):
        return parse_transfers_plain(tiles)
    L, NT, _T = steps.shape
    dev = steps.device
    out = torch.empty((L, NT, E_P), dtype=torch.uint8, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_parse_transfers(steps.data_ptr(), out.data_ptr(), L, NT, _build.stream(dev))
    _build.check(err, "td_parse_transfers")
    ENCODE_LAUNCHES["parse_transfers"] += 1
    return out


def host_entries(transfers: np.ndarray) -> np.ndarray:
    """(L, NT, E_P) transfer maps -> (L, NT) entry offsets of the chain
    from position 0 (the serial cross-tile seam, NT scalar steps a lane)."""
    L, NT, _E = transfers.shape
    entries = np.zeros((L, NT), np.int32)
    lanes = np.arange(L)
    e = np.zeros(L, np.int64)
    for t in range(1, NT):
        e = transfers[lanes, t - 1, e].astype(np.int64)
        entries[:, t] = e
    return entries


def parse_replay_plain(tiles: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """Plain K9: tiles (L, T_P, NT), entries (L, NT) int32 -> is-token
    bool (L, S): the positions the chain visits from each tile's entry."""
    L, _T, NT = tiles.shape
    cur = entries.to(torch.int32).clone()
    tok = torch.zeros((L, NT, T_P), dtype=torch.bool, device=tiles.device)
    for pos in range(T_P):
        at = cur == pos
        tok[:, :, pos] = at
        cur += torch.where(at, tiles[:, pos, :], 0)
    return tok.view(L, NT * T_P)


def parse_replay(tiles: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """K9: tiles (L, T_P, NT) int32, entries (L, NT) int32 -> (L, S) bool."""
    steps = _steps(tiles)
    _build.check_tensor("entries", entries, torch.int32, 2)
    L, NT, _T = steps.shape
    _build.require(tuple(entries.shape) == (L, NT), f"entries: shape {tuple(entries.shape)}")
    if not _build.on_card(steps, entries):
        return parse_replay_plain(tiles, entries)
    dev = steps.device
    out = torch.empty((L, NT * T_P), dtype=torch.bool, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.td_parse_replay(
            steps.data_ptr(), entries.data_ptr(), out.data_ptr(), L, NT, _build.stream(dev)
        )
    _build.check(err, "td_parse_replay")
    ENCODE_LAUNCHES["parse_replay"] += 1
    return out
