"""The device encoder's emit (counterpart of ``tpu_deflate.codec.emit_pallas``
and of the block routing in ``tpu_deflate.codec.encode_jax``): token info
-> each lane's DEFLATE block as packed words.

- ``emit_device``: the block header (at bit 0), the body (K10: code lookup,
  each position's bit fields, an exclusive bit-offset scan from the
  header's length) and the end-of-block code (after the body) of every
  lane -> (words, total_bits); one launch of ``csrc/emit.cu``;
- ``emit_routed``: the same launch with the block routing as its prologue:
  each lane's stored / fixed / dynamic bit costs, its cheapest strategy,
  and for lanes routed FIXED the fixed code tables, header and EOB in
  place of the planned ones -> (words, total_bits, choice, dynamic, fixed,
  stored); the function the encode paths call;
- their plain versions, which are the spec: ``emit_device_plain`` is
  ``emit_body_plain`` (the body from the header's length) then
  ``header_eob_plain`` (header and EOB built as a second word grid,
  ``header_eob_words_plain``, and ORed in: the regions hold disjoint
  bits); ``emit_routed_plain`` is ``route_plain`` then
  ``emit_device_plain``;
- ``emit_body``, ``header_eob`` and ``route``: those three steps alone,
  with their inputs checked, on CPU tensors (their plain versions). The
  card runs them only inside the one launch, so on CUDA tensors they
  raise.

Words are int32 tensors holding uint32 bit patterns. A word index at or
past ``EMIT_WORDS`` is dropped, never written, while the bit counts stay
exact: a lane whose bits overflow the grid costs more than stored framing,
and member assembly frames it as stored.

The body's plain version is the body-only form of the reference's XLA
emit (``encode_jax.emit_device``): two slots per position (litlen code +
length extra, distance code + distance extra), one cumulative sum, then
the low and high word parts of every slot added into the grid. Extra
values count only at match positions (the analysis holds them at 0
elsewhere). The routing's plain version is ``encode_jax.route_strategies``
then ``_apply_route``, in int32 arithmetic that wraps as the reference's
does.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import ENCODE_LAUNCHES
from .decode_kernels import wrap_int32

EMIT_WORDS = 176 * 128  # 22528 words per lane (the reference's WORD_ROWS x 128)
EMIT_CHUNK = 1024  # S must be a multiple of this
EMIT_SEGMENT = 4096  # positions per block of the kernel (SEG in csrc/emit.cu)
ROUTE_DYNAMIC, ROUTE_FIXED, ROUTE_STORED = 0, 1, 2
_M32 = 0xFFFFFFFF
_I32 = torch.int32
FIELDS = ("sym", "flags", "leb", "lev", "dsym", "deb", "dev")


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
    """Plain K10 body: seven (L, S) int32 token fields, ll_codes (L, 288)
    and d_codes (L, 30) int32 packed len << 16 | revcode, hdr_bits (L,)
    int32 the body's first bit -> (words (L, EMIT_WORDS) int32, body_end
    (L,) int32)."""
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


def emit_device_plain(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, header_vals, header_bits,
                      eob_val, eob_bits):
    """Plain emit: :func:`emit_body_plain` from the header's length (the sum
    of its slots' bits), then :func:`header_eob_plain` -> (words,
    total_bits)."""
    body_words, body_end = emit_body_plain(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes,
                                           header_bits.sum(dim=1, dtype=_I32))
    return header_eob_plain(body_words, header_vals, header_bits, eob_val, eob_bits, body_end)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def route_strategies_plain(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths):
    """Per-lane argmin over stored / fixed / dynamic bit costs, from the
    token histograms (no EOB, no bumps), the planned dynamic code lengths
    and header bits, and the member lengths; int32 throughout. Returns
    (choice, dyn_bits, fixed_bits, stored_bits), each (L,)."""
    devc = ll_hist.device
    sym = torch.arange(288, dtype=_I32, device=devc)[None, :]
    len_extra = torch.where((sym >= 265) & (sym <= 284), (sym - 261) >> 2, 0)
    dsym = torch.arange(30, dtype=_I32, device=devc)[None, :]
    dist_extra = ((dsym >> 1) - 1).clamp(min=0)

    def dot(a, b):
        return (a * b).sum(dim=1, dtype=_I32)

    extras = dot(ll_hist, len_extra) + dot(d_hist, dist_extra)
    fix_ll = torch.where(sym < 144, 8, torch.where(sym < 256, 9, torch.where(sym < 280, 7, 8)))
    dyn = hdr_bits + dot(ll_hist, ll_len) + dot(d_hist, d_len) + extras + ll_len[:, 256]
    fixed = 3 + dot(ll_hist, fix_ll) + dot(d_hist, torch.full_like(d_hist, 5)) + extras + 7
    stored = 8 * (lengths + 5 * ((lengths + 65534) // 65535) + 1)
    choice = torch.where(
        stored < torch.minimum(dyn, fixed),
        ROUTE_STORED,
        torch.where(fixed < dyn, ROUTE_FIXED, ROUTE_DYNAMIC),
    ).to(_I32)
    return choice, dyn, fixed, stored


def _apply_route_plain(choice, ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits, fix_ll,
                       fix_d, final=None):
    """Swap the fixed-Huffman codes, header (bfinal, btype 01) and EOB into
    lanes routed FIXED. ``final`` (L,) 0/1 is each lane's bfinal (None:
    every lane is final)."""
    f = (choice == ROUTE_FIXED)[:, None]
    fin = 1 if final is None else final.to(header_vals.dtype)
    ll = torch.where(f, fix_ll, ll_codes)
    dd = torch.where(f, fix_d, d_codes)
    hv = torch.where(f, 0, header_vals)
    hv[:, 0] = torch.where(f[:, 0], fin | 2, header_vals[:, 0])
    hb = torch.where(f, 0, header_bits)
    hb[:, 0] = torch.where(f[:, 0], 3, header_bits[:, 0])
    ev = torch.where(f[:, 0], 0, eob_val)
    eb = torch.where(f[:, 0], 7, eob_bits)
    return ll, dd, hv, hb, ev, eb


def route_plain(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, ll_codes, d_codes, header_vals,
                header_bits, eob_val, eob_bits, fix_ll, fix_d, final=None):
    """Plain routing: :func:`route_strategies_plain`, then
    :func:`_apply_route_plain` -> (ll_codes, d_codes, header_vals,
    header_bits, eob_val, eob_bits, choice, dyn_bits, fixed_bits,
    stored_bits)."""
    costs = route_strategies_plain(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths)
    routed = _apply_route_plain(costs[0], ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits, fix_ll,
                                fix_d, final)
    return (*routed, *costs)


def emit_routed_plain(sym, flags, leb, lev, dsym, deb, dev, ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths,
                      ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits, fix_ll, fix_d, final=None):
    """Plain routed emit: :func:`route_plain`, then
    :func:`emit_device_plain` with the routed tables, header and EOB ->
    (words, total_bits, choice, dyn_bits, fixed_bits, stored_bits)."""
    *routed, choice, dyn, fixed, stored = route_plain(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, ll_codes,
                                                      d_codes, header_vals, header_bits, eob_val, eob_bits, fix_ll,
                                                      fix_d, final)
    words, total_bits = emit_device_plain(sym, flags, leb, lev, dsym, deb, dev, *routed)
    return words, total_bits, choice, dyn, fixed, stored


# ---------------------------------------------------------------------------
# Argument checks and the launch
# ---------------------------------------------------------------------------


def _check_body(fields, ll_codes, d_codes) -> tuple[int, int]:
    """The token fields (L, S) int32, S a multiple of EMIT_CHUNK, and the
    code tables (L, 288), (L, 30) int32 -> (L, S)."""
    sym = fields[0]
    for name, t in zip(FIELDS, fields):
        _build.check_tensor(name, t, _I32, 2)
        _build.require(t.shape == sym.shape, f"{name}: shape {tuple(t.shape)} != sym's")
    L, S = sym.shape
    _build.require(S % EMIT_CHUNK == 0, f"sym: width {S} must be a multiple of {EMIT_CHUNK}")
    _build.check_tensor("ll_codes", ll_codes, _I32, 2)
    _build.check_tensor("d_codes", d_codes, _I32, 2)
    _build.require(tuple(ll_codes.shape) == (L, 288), f"ll_codes: shape {tuple(ll_codes.shape)}")
    _build.require(tuple(d_codes.shape) == (L, 30), f"d_codes: shape {tuple(d_codes.shape)}")
    return L, S


def _check_header(L: int, header_vals, header_bits, eob_val, eob_bits) -> None:
    """The header (L, H) int64 values and int32 bit counts, the EOB (L,)
    int64 value and int32 bit count."""
    _build.check_tensor("header_vals", header_vals, torch.int64, 2)
    _build.check_tensor("header_bits", header_bits, _I32, 2)
    _build.require(header_vals.shape == header_bits.shape and header_vals.shape[0] == L,
                   f"header: shapes {tuple(header_vals.shape)}, {tuple(header_bits.shape)}")
    for name, t, dtype in (("eob_val", eob_val, torch.int64), ("eob_bits", eob_bits, _I32)):
        _build.check_tensor(name, t, dtype, 1)
        _build.require(t.shape[0] == L, f"{name}: shape {tuple(t.shape)}")


def _check_route(L: int, ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, fix_ll, fix_d, final) -> list:
    """The routing's inputs (shapes as :func:`route` takes them) -> the
    tensors among them."""
    named = (("ll_hist", ll_hist, (L, 288)), ("d_hist", d_hist, (L, 30)), ("ll_len", ll_len, (L, 288)),
             ("d_len", d_len, (L, 30)), ("hdr_bits", hdr_bits, (L,)), ("lengths", lengths, (L,)),
             ("fix_ll", fix_ll, (1, 288)), ("fix_d", fix_d, (1, 30)))
    for name, t, shape in named:
        _build.check_tensor(name, t, _I32, len(shape))
        _build.require(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)}, expected {shape}")
    tensors = [t for _name, t, _s in named]
    if final is not None:
        _build.check_tensor("final", final, torch.int64, 1)
        _build.require(tuple(final.shape) == (L,), f"final: shape {tuple(final.shape)}")
        tensors.append(final)
    return tensors


def _launch(fields, tables, route_args, L: int, S: int):
    """One launch of ``td_emit``: fields, tables = (ll_codes, d_codes,
    header_vals, header_bits, eob_val, eob_bits), route_args the routing's
    nine inputs (``final`` may be None) or None (routing off) -> (words,
    total_bits, costs (4, L) int32 or None)."""
    _build.require(all(t.data_ptr() % 16 == 0 for t in fields),
                   "token fields: the kernel reads them in 16-byte vectors and needs them aligned")
    devc = fields[0].device
    # Zero-filled: segments OR their shared first and last words, the
    # header and EOB are ORed in, and the words past the body stay 0. The
    # scratch holds each (lane, segment)'s look-back status word, then the
    # segments' ticket counter.
    words = torch.zeros((L, EMIT_WORDS), dtype=_I32, device=devc)
    total_bits = torch.empty(L, dtype=_I32, device=devc)
    costs = None if route_args is None else torch.empty((4, L), dtype=_I32, device=devc)
    scratch = torch.zeros(L * -(-S // EMIT_SEGMENT) + 1, dtype=torch.int64, device=devc)
    ptrs = [0] * 9 if route_args is None else [0 if t is None else t.data_ptr() for t in route_args]
    lib = _build.load()
    with torch.cuda.device(devc):
        err = lib.td_emit(
            *(t.data_ptr() for t in (*fields, *tables)), *ptrs, words.data_ptr(), total_bits.data_ptr(),
            0 if costs is None else costs.data_ptr(), scratch.data_ptr(), L, S, tables[2].shape[1],
            _build.stream(devc),
        )
    _build.check(err, "td_emit")
    ENCODE_LAUNCHES["emit_body"] += 1
    return words, total_bits, costs


def emit_device(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, header_vals, header_bits, eob_val,
                eob_bits):
    """Header, body (K10) and EOB of every lane, each lane with its own
    tables, header and EOB: the seven (L, S) int32 token fields (16-byte
    aligned on the card), ll_codes (L, 288) and d_codes (L, 30) int32
    packed len << 16 | revcode, the header (L, H) int64 values and int32
    bit counts, the EOB (L,) int64 value and int32 bit count -> (words (L,
    EMIT_WORDS) int32, total_bits (L,) int32). On the card one launch of
    ``td_emit`` with routing off; on the CPU :func:`emit_device_plain`."""
    fields = (sym, flags, leb, lev, dsym, deb, dev)
    L, S = _check_body(fields, ll_codes, d_codes)
    tables = (ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits)
    _check_header(L, *tables[2:])
    if not _build.on_card(*fields, *tables):
        return emit_device_plain(*fields, *tables)
    words, total_bits, _costs = _launch(fields, tables, None, L, S)
    return words, total_bits


def emit_routed(sym, flags, leb, lev, dsym, deb, dev, ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths,
                ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits, fix_ll, fix_d, final=None):
    """Each lane's cheapest block strategy, then its header, body (K10) and
    EOB, with the fixed tables, header (bfinal | 2 in 3 bits) and EOB (0 in
    7 bits) for lanes routed FIXED: :func:`emit_device`'s token fields; the
    histograms (L, 288), (L, 30), the planned code lengths (L, 288), (L,
    30), the planned header's bits and the member lengths (L,), all int32;
    the planned codes, header and EOB as :func:`emit_device` takes them;
    the fixed tables (1, 288), (1, 30) int32; ``final`` (L,) int64 0/1 or
    None (every lane final) -> (words, total_bits, choice, dyn_bits,
    fixed_bits, stored_bits), the last four (L,) int32. On the card one
    launch of ``td_emit`` with routing on (nothing is written into the
    inputs); on the CPU :func:`emit_routed_plain`."""
    fields = (sym, flags, leb, lev, dsym, deb, dev)
    L, S = _check_body(fields, ll_codes, d_codes)
    tables = (ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits)
    _check_header(L, *tables[2:])
    route_tensors = _check_route(L, ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, fix_ll, fix_d, final)
    if not _build.on_card(*fields, *tables, *route_tensors):
        return emit_routed_plain(*fields, ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, *tables, fix_ll,
                                 fix_d, final)
    route_args = (ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, fix_ll, fix_d, final)
    words, total_bits, costs = _launch(fields, tables, route_args, L, S)
    return (words, total_bits, *costs)


# ---------------------------------------------------------------------------
# The three steps alone (CPU tensors)
# ---------------------------------------------------------------------------


def _cpu_only(name: str, *tensors: torch.Tensor) -> None:
    _build.require(not _build.on_card(*tensors),
                   f"{name}: the card runs this step only inside the emit's one launch "
                   "(emit_device, emit_routed)")


def emit_body(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, hdr_bits):
    """The body alone, inputs checked: :func:`emit_body_plain` on CPU
    tensors."""
    fields = (sym, flags, leb, lev, dsym, deb, dev)
    L, _S = _check_body(fields, ll_codes, d_codes)
    _build.check_tensor("hdr_bits", hdr_bits, _I32, 1)
    _build.require(tuple(hdr_bits.shape) == (L,), f"hdr_bits: shape {tuple(hdr_bits.shape)}")
    _cpu_only("emit_body", *fields, ll_codes, d_codes, hdr_bits)
    return emit_body_plain(*fields, ll_codes, d_codes, hdr_bits)


def header_eob(words, header_vals, header_bits, eob_val, eob_bits, body_end):
    """The header and EOB alone, inputs checked: :func:`header_eob_plain`
    on CPU tensors (words (L, EMIT_WORDS) int32, body_end (L,) int32)."""
    _build.check_tensor("words", words, _I32, 2)
    L = words.shape[0]
    _build.require(words.shape[1] == EMIT_WORDS, f"words: shape {tuple(words.shape)}")
    _check_header(L, header_vals, header_bits, eob_val, eob_bits)
    _build.check_tensor("body_end", body_end, _I32, 1)
    _build.require(body_end.shape[0] == L, f"body_end: shape {tuple(body_end.shape)}")
    args = (words, header_vals, header_bits, eob_val, eob_bits, body_end)
    _cpu_only("header_eob", *args)
    return header_eob_plain(*args)


def route(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, ll_codes, d_codes, header_vals, header_bits,
          eob_val, eob_bits, fix_ll, fix_d, final=None):
    """The routing alone, inputs checked (:func:`emit_routed`'s routing,
    code, header and EOB arguments): :func:`route_plain` on CPU tensors."""
    L = ll_hist.shape[0]
    route_tensors = _check_route(L, ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, fix_ll, fix_d, final)
    for name, t, dtype, shape in (("ll_codes", ll_codes, _I32, (L, 288)), ("d_codes", d_codes, _I32, (L, 30))):
        _build.check_tensor(name, t, dtype, 2)
        _build.require(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)}, expected {shape}")
    _check_header(L, header_vals, header_bits, eob_val, eob_bits)
    _cpu_only("route", *route_tensors, ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits)
    return route_plain(ll_hist, d_hist, ll_len, d_len, hdr_bits, lengths, ll_codes, d_codes, header_vals,
                       header_bits, eob_val, eob_bits, fix_ll, fix_d, final)
