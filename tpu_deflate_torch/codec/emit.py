"""The device encoder's word packer (counterpart of
``tpu_deflate.codec.emit_pallas``): token info -> packed DEFLATE bit-stream
words per lane.

- ``emit_body`` (K10): code lookup, each position's bit fields, an
  exclusive bit-offset scan from the header's length, and the bits ORed
  into a lane's ``EMIT_WORDS``-word grid; returns the body's end bit;
- ``header_eob``: the block header (at bit 0) and the end-of-block code
  (after the body) ORed into the body's words; its plain version builds
  them as a second word grid (``header_eob_words_plain``, the spec) and
  ORs the two (the regions hold disjoint bits);
- ``emit_device``: both, the function the encode pipeline calls.

Words are int32 tensors holding uint32 bit patterns. A word index at or
past ``EMIT_WORDS`` is dropped, never written, while the bit counts stay
exact: a lane whose bits overflow the grid costs more than stored framing,
and member assembly frames it as stored.

``emit_body`` and ``header_eob`` run the CUDA kernels of ``csrc/emit.cu``
on CUDA tensors and the plain PyTorch versions beside them on CPU tensors. The plain version is
the body-only form of the reference's XLA emit (``encode_jax.emit_device``):
two slots per position (litlen code + length extra, distance code +
distance extra), one cumulative sum, then the low and high word parts of
every slot added into the grid. Extra values count only at match
positions (the analysis holds them at 0 elsewhere).
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import ENCODE_LAUNCHES
from .decode_kernels import wrap_int32

EMIT_WORDS = 176 * 128  # 22528 words per lane (the reference's WORD_ROWS x 128)
EMIT_CHUNK = 1024  # S must be a multiple of this
EMIT_SEGMENT = 4096  # positions per block of the kernel (SEG in csrc/emit.cu)
_M32 = 0xFFFFFFFF


def _or_words(offs: torch.Tensor, vals: torch.Tensor, bits: torch.Tensor, width: int) -> torch.Tensor:
    """(L, n) bit offsets, values (< 2**32, int64) and bit counts -> (L,
    width) int64 words with every slot of bits > 0 placed at its offset;
    parts past the grid are dropped. Slots hold disjoint bits, so the adds
    are ORs."""
    L = offs.shape[0]
    w = offs >> 5
    sh = offs & 31
    lo = (vals << sh) & _M32
    hi = torch.where(sh > 0, vals >> (32 - sh), 0)
    live = bits > 0
    words = torch.zeros((L, width + 1), dtype=torch.int64, device=offs.device)
    words.scatter_add_(1, torch.where(live, w, width).clamp(max=width), lo)
    words.scatter_add_(1, torch.where(live, w + 1, width).clamp(max=width), hi)
    return words[:, :width]


def emit_body_plain(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, hdr_bits):
    """Plain K10: seven (L, S) int32 token fields, ll_codes (L, 288) and
    d_codes (L, 30) int32 packed len << 16 | revcode, hdr_bits (L,) int32
    -> (words (L, EMIT_WORDS) int32, body_end (L,) int32)."""
    L, S = sym.shape
    i64 = torch.int64
    is_tok = (flags & 1) != 0
    is_match = (flags & 2) != 0
    ll = ll_codes.to(i64).gather(1, sym.clamp(0, 287).to(i64))
    dd = d_codes.to(i64).gather(1, dsym.clamp(0, 29).to(i64))
    v0 = torch.where(is_tok, ll & 0xFFFF, 0)
    b0 = torch.where(is_tok, ll >> 16, 0)
    v1 = torch.where(is_match, lev.to(i64), 0)
    b1 = torch.where(is_match, leb.to(i64), 0)
    v2 = torch.where(is_match, dd & 0xFFFF, 0)
    b2 = torch.where(is_match, dd >> 16, 0)
    v3 = torch.where(is_match, dev.to(i64), 0)
    b3 = torch.where(is_match, deb.to(i64), 0)
    vals = torch.stack([(v0 | (v1 << b0)) & _M32, (v2 | (v3 << b2)) & _M32], dim=2).view(L, 2 * S)
    bits = torch.stack([b0 + b1, b2 + b3], dim=2).view(L, 2 * S)
    ends = torch.cumsum(bits, dim=1) + hdr_bits.to(i64)[:, None]
    words = _or_words(ends - bits, vals, bits, EMIT_WORDS)
    return wrap_int32(words).to(torch.int32), ends[:, -1].to(torch.int32)


def emit_body(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, hdr_bits):
    """K10: the same inputs and outputs as :func:`emit_body_plain`."""
    fields = {"sym": sym, "flags": flags, "leb": leb, "lev": lev, "dsym": dsym, "deb": deb,
              "dev": dev}
    for name, t in fields.items():
        _build.check_tensor(name, t, torch.int32, 2)
        _build.require(t.shape == sym.shape, f"{name}: shape {tuple(t.shape)} != sym's")
    L, S = sym.shape
    _build.require(S % EMIT_CHUNK == 0, f"sym: width {S} must be a multiple of {EMIT_CHUNK}")
    _build.check_tensor("ll_codes", ll_codes, torch.int32, 2)
    _build.check_tensor("d_codes", d_codes, torch.int32, 2)
    _build.check_tensor("hdr_bits", hdr_bits, torch.int32, 1)
    _build.require(tuple(ll_codes.shape) == (L, 288), f"ll_codes: shape {tuple(ll_codes.shape)}")
    _build.require(tuple(d_codes.shape) == (L, 30), f"d_codes: shape {tuple(d_codes.shape)}")
    _build.require(tuple(hdr_bits.shape) == (L,), f"hdr_bits: shape {tuple(hdr_bits.shape)}")
    args = (*fields.values(), ll_codes, d_codes, hdr_bits)
    if not _build.on_card(*args):
        return emit_body_plain(*args)
    _build.require(all(t.data_ptr() % 16 == 0 for t in fields.values()),
                   "token fields: the kernel reads them in 16-byte vectors and needs them aligned")
    devc = sym.device
    # Zero-filled: segments OR their shared first and last words, and the
    # words past the body stay 0. The scratch holds each (lane, segment)'s
    # look-back status word, then the segments' ticket counter.
    words = torch.zeros((L, EMIT_WORDS), dtype=torch.int32, device=devc)
    body_end = torch.empty(L, dtype=torch.int32, device=devc)
    scratch = torch.zeros(L * -(-S // EMIT_SEGMENT) + 1, dtype=torch.int64, device=devc)
    lib = _build.load()
    with torch.cuda.device(devc):
        err = lib.td_emit_body(
            *(t.data_ptr() for t in args), words.data_ptr(), body_end.data_ptr(),
            scratch.data_ptr(), L, S, _build.stream(devc),
        )
    _build.check(err, "td_emit_body")
    ENCODE_LAUNCHES["emit_body"] += 1
    return words, body_end


def header_eob_words_plain(header_vals, header_bits, eob_val, eob_bits, body_end):
    """Header (at bit 0) and EOB (at body_end) as an (L, EMIT_WORDS) int32
    word grid to OR with the body's words; returns (words, total_bits).
    header_vals (L, H) and eob_val (L,) hold uint32 values in int64."""
    i64 = torch.int64
    vals = torch.cat([header_vals.to(i64), eob_val.to(i64)[:, None]], dim=1)
    bits = torch.cat([header_bits.to(i64), eob_bits.to(i64)[:, None]], dim=1)
    ends = torch.cumsum(header_bits.to(i64), dim=1)
    offs = torch.cat([ends - header_bits.to(i64), body_end.to(i64)[:, None]], dim=1)
    words = _or_words(offs, vals, bits, EMIT_WORDS)
    return wrap_int32(words).to(torch.int32), (body_end + eob_bits).to(torch.int32)


def header_eob_plain(words, header_vals, header_bits, eob_val, eob_bits, body_end):
    """Plain header/EOB: ``words | header_eob_words_plain(...)`` and the
    total bits."""
    he_words, total_bits = header_eob_words_plain(header_vals, header_bits, eob_val, eob_bits, body_end)
    return words | he_words, total_bits


def header_eob(words, header_vals, header_bits, eob_val, eob_bits, body_end):
    """The header (L, H) int64 values and int32 bit counts placed from bit 0
    and the EOB (L,) at ``body_end`` (L,) int32, ORed into K10's words (L,
    EMIT_WORDS) int32 -> (words, total_bits (L,) int32). On the card one
    launch of ``td_header_eob``, which ORs into ``words`` in place (the
    emit owns them; no second grid); on the CPU
    :func:`header_eob_plain`."""
    _build.check_tensor("words", words, torch.int32, 2)
    L = words.shape[0]
    _build.require(words.shape[1] == EMIT_WORDS, f"words: shape {tuple(words.shape)}")
    _build.check_tensor("header_vals", header_vals, torch.int64, 2)
    _build.check_tensor("header_bits", header_bits, torch.int32, 2)
    _build.require(header_vals.shape == header_bits.shape and header_vals.shape[0] == L,
                   f"header: shapes {tuple(header_vals.shape)}, {tuple(header_bits.shape)}")
    for name, t, dtype in (("eob_val", eob_val, torch.int64), ("eob_bits", eob_bits, torch.int32),
                           ("body_end", body_end, torch.int32)):
        _build.check_tensor(name, t, dtype, 1)
        _build.require(t.shape[0] == L, f"{name}: shape {tuple(t.shape)}")
    args = (words, header_vals, header_bits, eob_val, eob_bits, body_end)
    if not _build.on_card(*args):
        return header_eob_plain(*args)
    devc = words.device
    total_bits = torch.empty(L, dtype=torch.int32, device=devc)
    lib = _build.load()
    with torch.cuda.device(devc):
        err = lib.td_header_eob(header_vals.data_ptr(), header_bits.data_ptr(), eob_val.data_ptr(),
                                eob_bits.data_ptr(), body_end.data_ptr(), words.data_ptr(), total_bits.data_ptr(),
                                L, header_vals.shape[1], _build.stream(devc))
    _build.check(err, "td_header_eob")
    ENCODE_LAUNCHES["header_eob"] += 1
    return words, total_bits


def body_args(args: tuple) -> tuple:
    """:func:`emit_device`'s arguments -> :func:`emit_body`'s: the token
    fields and code tables, and each lane's header bit length."""
    return (*args[:9], args[10].sum(dim=1).to(torch.int32))


def emit_device(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, header_vals,
                header_bits, eob_val, eob_bits):
    """Header, body (K10) and EOB of every lane -> (words (L, EMIT_WORDS)
    int32, total_bits (L,) int32)."""
    body_words, body_end = emit_body(*body_args((sym, flags, leb, lev, dsym, deb, dev, ll_codes,
                                                 d_codes, header_vals, header_bits)))
    return header_eob(body_words, header_vals, header_bits, eob_val, eob_bits, body_end)
