"""Continuous-history device encode (counterpart of the continuous half of
``tpu_deflate.codec.encode_jax``): the max-ratio mode, one gzip member
whose DEFLATE blocks match across block boundaries through a sliding
32 KiB history.

The input splits into ``block_data`` blocks, one lane each. A lane's row
is ``[halo | payload | padding]``: the ``HALO_COLS`` bytes of input before
its block (fewer at the stream's head, left-padded with zeros; ``hstart``
is the first real column), its block, and zero columns up to a multiple of
``ROW_ALIGN``. The member encoder's stages (``encode.py``) run on these
rows with ``hist``/``hstart``: match candidates reach into the halo,
tokens cover only the payload, and each lane codes one block, final only
for the last lane. The host splices the blocks' bit streams at the running
bit offset (:class:`BitSplicer`) into one member. The member CRC-32 is
taken on the card from the rows' payload columns (the lane CRC, through
``checksum_lanes.crc32_device``).

Lanes are independent given their halos, which come from the input, so the
batches run in the member encoder's three-stage pipeline
(``encode.run_pipeline``); only the splice is serial. With a mesh
(``dist.mesh``) each batch's lanes pad to a multiple of the shard count
with 1-byte lanes that are never final (the reference's padding) and cut
into contiguous shards; each shard runs the match finder, K8, K9, K10 and
its part of the member CRC on its own device, and the padding lanes are
dropped before the splice. The member is byte-identical to the unsharded
one. Across ranks the encode is replicated: each rank encodes the whole
input over its own devices.

The output is byte-identical to ``encode_jax.compress_continuous_tpu`` at
the same effort and ``block_data``, except where the reference's faults
fire; there it decodes correctly:

- F1: the RLE lanes never match into the head lane's padding
  (``encode._match_find``);
- F2: a lane whose bits overflow the emit's word grid (``emit.EMIT_WORDS``)
  is spliced as stored;
- F11: candidates past column 2**18 keep their distances (the int64
  packing of ``encode._bucket_best``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..dist.mesh import LaneSharding, lane_sharding, pad_lanes
from ..kernels.checksum_lanes import crc32_device
from ..native import _EMPTY_MEMBER
from .emit import EMIT_CHUNK, EMIT_WORDS, emit_device
from .encode import ENC_LANE_BATCH, ROUTE_STORED, dispatch_phase1, emit_inputs, run_pipeline
from .encode_np import MAX_STORED_BLOCK, MEMBER_DATA, build_member
from .parse import T_P

HALO_COLS = 32 * 1024  # history columns before each lane's payload
ROW_ALIGN = max(T_P, EMIT_CHUNK)  # row widths are a multiple of both


class BitSplicer:
    """One bit stream built from blocks appended at any bit offset (the
    reference's ``_BitSplicer``). Huffman blocks do not depend on their
    offset; stored blocks pad to a byte from it, so they are framed here."""

    def __init__(self):
        self.out = bytearray()
        self.bitpos = 0

    def append(self, sb: bytes, nbits: int) -> None:
        """Append the first ``nbits`` bits of ``sb`` (LSB first; bits past
        them must be zero)."""
        if nbits == 0:
            return
        r = self.bitpos & 7
        arr = np.frombuffer(sb, np.uint8)
        if r == 0:
            self.out += sb
        else:
            lo = ((arr.astype(np.uint16) << r) & 0xFF).astype(np.uint8)
            hi = (arr >> (8 - r)).astype(np.uint8)
            self.out[-1] |= int(lo[0])
            self.out += (lo[1:] | hi[:-1]).tobytes()
            self.out.append(int(hi[-1]))
        self.bitpos += nbits
        del self.out[(self.bitpos + 7) // 8 :]

    def append_aligned(self, sb: bytes, nbits: int) -> None:
        """Append ``nbits`` bits that were encoded to start at bit
        ``bitpos % 8`` of ``sb``'s first byte (its bits below that are zero),
        so stored blocks among them sit at their true alignment."""
        r = self.bitpos & 7
        if r:
            self.out[-1] |= sb[0]
            self.out += sb[1:]
        else:
            self.out += sb
        self.bitpos += nbits
        del self.out[(self.bitpos + 7) // 8 :]

    def append_stored(self, data: bytes, final: bool) -> None:
        """``data`` as stored blocks of at most 65535 bytes (one empty
        block for no data); bfinal on the last block if ``final``."""
        index, end = 0, len(data)
        while True:
            n = min(end - index, MAX_STORED_BLOCK)
            self.append(bytes([int(final and index + n == end)]), 3)  # bfinal, btype 00
            self.out += n.to_bytes(2, "little") + (n ^ 0xFFFF).to_bytes(2, "little")
            self.out += data[index : index + n]
            self.bitpos = 8 * len(self.out)
            index += n
            if index >= end:
                return

    def payload(self) -> bytes:
        return bytes(self.out)


def lane_rows(flat: np.ndarray, first: int, count: int, block_data: int, lanes: int | None = None):
    """Host rows of lanes first .. first + count - 1 of ``flat``: (rows
    (lanes, S) uint8, hstart, pay_lens, final, each (lanes,) int32), S the
    smallest multiple of ROW_ALIGN that holds HALO_COLS + block_data. The
    ``lanes - count`` rows past them (none by default) are padding lanes:
    zero rows of one payload byte, no history, never final."""
    n = flat.size
    lanes = count if lanes is None else lanes
    S = -(-(HALO_COLS + block_data) // ROW_ALIGN) * ROW_ALIGN
    rows = np.zeros((lanes, S), np.uint8)
    hstart = np.full(lanes, HALO_COLS, np.int32)
    pay_lens = np.ones(lanes, np.int32)
    final = np.zeros(lanes, np.int32)
    for i in range(count):
        p0 = (first + i) * block_data
        h = min(HALO_COLS, p0)
        ln = min(block_data, n - p0)
        rows[i, HALO_COLS - h : HALO_COLS + ln] = flat[p0 - h : p0 + ln]
        hstart[i], pay_lens[i], final[i] = HALO_COLS - h, ln, p0 + ln >= n
    return rows, hstart, pay_lens, final


def dispatch_lanes(rows: torch.Tensor, hstart: torch.Tensor, pay_lens: np.ndarray, lazy: bool,
                   quality: int):
    """Stage 1 of a batch of lane rows on their device: phase 1 with the
    history masks -> the pending batch :func:`encode.emit_inputs` takes."""
    L = rows.shape[0]
    dev = rows.device
    lengths = torch.from_numpy((HALO_COLS + pay_lens).astype(np.int32)).to(dev)
    hist = torch.full((L,), HALO_COLS, dtype=torch.int32, device=dev)
    return (rows, *dispatch_phase1(rows, lengths, lazy, quality, hist, hstart), None, pay_lens)


def _emit_lanes(pend, final: np.ndarray):
    """Stage 2: the host walk, phase 2, planning with ``final`` and the
    emit (K10) -> (words (L, EMIT_WORDS) int32, total_bits (L,) int32,
    route choice (L,)), on the rows' device."""
    args, _tiles, _entries, choice = emit_inputs(pend, final)
    return (*emit_device(*args), choice)


def continuous_encode_lanes(rows: torch.Tensor, hstart: torch.Tensor, pay_lens: np.ndarray,
                            final: np.ndarray, lazy: bool, quality: int):
    """One batch of lanes, both stages (``_continuous_encode_lanes``)."""
    return _emit_lanes(dispatch_lanes(rows, hstart, pay_lens, lazy, quality), final)


def _on(dev: torch.device):
    """The device's context (a shard's events and copies go to its stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def compress_continuous(data: bytes, *, device: torch.device | None = None, mesh=None, effort: int = 4,
                        block_data: int = MEMBER_DATA, lane_batch: int = ENC_LANE_BATCH) -> bytes:
    """Encode ``data`` as one gzip member of ``block_data`` blocks with
    continuous 32 KiB history, on ``device`` (kernels on a CUDA device,
    their plain versions on the CPU) or with each batch's lanes cut over
    ``mesh`` (``dist.mesh.CodecMesh``; pass one of the two), ``lane_batch``
    lanes a batch before the padding. The parse is lazy; effort >= 5 takes
    the deepest candidate set. A mesh across ranks gives its process's part
    (``CodecMesh.local``) the whole input: every rank encodes every batch
    over its own devices and returns the same member."""
    if (device is None) == (mesh is None):
        raise ValueError("pass a device or a mesh")
    n = len(data)
    if n == 0:
        return _EMPTY_MEMBER
    sh = LaneSharding.one(device) if mesh is None else lane_sharding(mesh.local(), None)
    quality = 2 if effort >= 5 else 1
    flat = np.frombuffer(data, np.uint8)
    nlanes = -(-n // block_data)
    sp = BitSplicer()
    crc = 0

    def dispatch(first):
        count = min(lane_batch, nlanes - first)
        rows, hstart, pay_lens, final = lane_rows(flat, first, count, block_data, pad_lanes(count, sh.n))
        shards = []  # (pending stage 1, first lane, its finals, its real lanes), in lane order
        for dev, (a, b) in zip(sh.devices, sh.bounds(rows.shape[0], real=count)):
            with _on(dev):
                pend = dispatch_lanes(torch.from_numpy(rows[a:b]).to(dev), torch.from_numpy(hstart[a:b]).to(dev),
                                      pay_lens[a:b], True, quality)
            shards.append((pend, first + a, final[a:b], min(b, count) - a))
        return shards

    def emit(shards):
        out = []
        for pend, first, final, real in shards:
            with _on(pend[0].device):
                out.append((*_emit_lanes(pend, final), pend[0], first, pend[-1], final, real))
        return out

    def splice(em):
        for shard in em:
            splice_shard(*shard)

    def splice_shard(words, total_bits, choice, rows, first, pay_lens, final, real):
        nonlocal crc
        pay_lens = pay_lens[:real]
        payload = rows[:real, HALO_COLS : HALO_COLS + block_data].reshape(-1)[: int(pay_lens.sum())]
        crc = crc32_device(payload, crc)
        total_bits = total_bits[:real].cpu().numpy()
        choice = choice[:real].cpu().numpy()
        ln = pay_lens.astype(np.int64)
        stored_bits = 8 * (ln + 5 * (-(-ln // MAX_STORED_BLOCK)) + 1)
        # The device's route, with the emitted size as a backstop in bits (the
        # reference's), and stored framing for a lane whose bits overflow the
        # word grid (F2).
        huff = (choice != ROUTE_STORED) & (total_bits < stored_bits) & (total_bits <= 32 * EMIT_WORDS)
        mw = max(-(-int(total_bits[huff].max(initial=0)) // 32), 1)
        wbytes = words[:real, :mw].contiguous().cpu().numpy().view(np.uint8)
        for i in range(real):
            nb = int(total_bits[i])
            if huff[i]:
                sp.append(wbytes[i, : (nb + 7) // 8].tobytes(), nb)
            else:
                p0 = (first + i) * block_data
                sp.append_stored(flat[p0 : p0 + int(ln[i])].tobytes(), bool(final[i]))

    run_pipeline(list(range(0, nlanes, lane_batch)), dispatch, emit, splice)
    return build_member(sp.payload(), n, crc)
