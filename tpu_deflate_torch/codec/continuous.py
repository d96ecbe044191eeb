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
(``encode.run_pipeline``); only the splice is serial.

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

import numpy as np
import torch

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


def lane_rows(flat: np.ndarray, first: int, count: int, block_data: int):
    """Host rows of lanes first .. first + count - 1 of ``flat``: (rows
    (count, S) uint8, hstart, pay_lens, final, each (count,) int32), S the
    smallest multiple of ROW_ALIGN that holds HALO_COLS + block_data."""
    n = flat.size
    S = -(-(HALO_COLS + block_data) // ROW_ALIGN) * ROW_ALIGN
    rows = np.zeros((count, S), np.uint8)
    hstart = np.empty(count, np.int32)
    pay_lens = np.empty(count, np.int32)
    final = np.empty(count, np.int32)
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


def compress_continuous(data: bytes, *, device: torch.device, effort: int = 4,
                        block_data: int = MEMBER_DATA, lane_batch: int = ENC_LANE_BATCH) -> bytes:
    """Encode ``data`` as one gzip member of ``block_data`` blocks with
    continuous 32 KiB history, on ``device`` (kernels on a CUDA device,
    their plain versions on the CPU), ``lane_batch`` lanes a batch. The
    parse is lazy; effort >= 5 takes the deepest candidate set."""
    n = len(data)
    if n == 0:
        return _EMPTY_MEMBER
    quality = 2 if effort >= 5 else 1
    flat = np.frombuffer(data, np.uint8)
    nlanes = -(-n // block_data)
    sp = BitSplicer()
    crc = 0

    def dispatch(first):
        rows, hstart, pay_lens, final = lane_rows(flat, first, min(lane_batch, nlanes - first), block_data)
        pend = dispatch_lanes(torch.from_numpy(rows).to(device), torch.from_numpy(hstart).to(device),
                              pay_lens, True, quality)
        return pend, first, final

    def emit(d):
        pend, first, final = d
        return (*_emit_lanes(pend, final), pend[0], first, pend[-1], final)

    def splice(em):
        nonlocal crc
        words, total_bits, choice, rows, first, pay_lens, final = em
        payload = rows[:, HALO_COLS : HALO_COLS + block_data].reshape(-1)[: int(pay_lens.sum())]
        crc = crc32_device(payload, crc)
        total_bits = total_bits.cpu().numpy()
        choice = choice.cpu().numpy()
        ln = pay_lens.astype(np.int64)
        stored_bits = 8 * (ln + 5 * (-(-ln // MAX_STORED_BLOCK)) + 1)
        # The device's route, with the emitted size as a backstop in bits (the
        # reference's), and stored framing for a lane whose bits overflow the
        # word grid (F2).
        huff = (choice != ROUTE_STORED) & (total_bits < stored_bits) & (total_bits <= 32 * EMIT_WORDS)
        mw = max(-(-int(total_bits[huff].max(initial=0)) // 32), 1)
        wbytes = words[:, :mw].contiguous().cpu().numpy().view(np.uint8)
        for i in range(len(pay_lens)):
            nb = int(total_bits[i])
            if huff[i]:
                sp.append(wbytes[i, : (nb + 7) // 8].tobytes(), nb)
            else:
                p0 = (first + i) * block_data
                sp.append_stored(flat[p0 : p0 + int(ln[i])].tobytes(), bool(final[i]))

    run_pipeline(list(range(0, nlanes, lane_batch)), dispatch, emit, splice)
    return build_member(sp.payload(), n, crc)
