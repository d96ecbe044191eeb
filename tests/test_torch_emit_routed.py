"""The emit's one launch with its routing (``emit.emit_routed``: on the card
``emit_kernel`` of csrc/emit.cu, routing, header, body and EOB in one
launch a batch) on the CPU.

- The plain version, which is the spec (``emit_routed_plain`` =
  ``route_plain``, then ``emit_device_plain`` = ``emit_body_plain`` from the
  header's length, then ``header_eob_plain``), fed by the port's planner
  (``encode._plan_codes``), against the JAX package's ``_plan_codes`` then
  ``emit_pallas.emit_device_pallas`` (its Pallas kernel in interpret
  mode): one batch with lanes routed dynamic, fixed and stored, ``final``
  None, all 0 and mixed. Words, total bits and the route are equal.
- A NumPy mirror of the kernel's block decomposition against the plain
  version: a block per (lane, segment of 4096 positions); each block
  routes its lane itself (uint32 sums that wrap, the reference's tie
  order) and takes the fixed tables for a FIXED lane; segment 0's block
  places the header (each slot's offset from a scan of the slots' bits;
  bfinal | 2 in 3 bits for a FIXED lane) and starts the body at the
  header's length; each later segment starts where the look-back puts it
  (the header's length plus the earlier segments' bits); the last
  segment's block places the EOB at the body's end (0 in 7 bits for a
  FIXED lane) and writes the total bits. A segment with a slot of more
  than 31 bits, or more bits than its buffer, ORs its slots one by one
  (the direct path); any other builds its words in a buffer and ORs its
  first and last word and stores the words between them. The blocks run
  in a random order, and a plain store overwrites: a header or EOB that
  met a word some segment stores plainly would lose bits. Edge lanes: a
  header that ends on a word boundary and one that ends inside segment 0's
  first word, an empty body, a segment on the direct path, an EOB that
  straddles the grid's end and one past it, a FIXED lane whose dynamic
  header was longer than its body, member lengths 0, 1, 65535 and 65536;
  and the smoke's own edge lanes (``chip_smoke.routed_edge_lanes``,
  ``chip_smoke.header_eob_edge_lanes``).

Everything is integer, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import emit_pallas as ep
from tpu_deflate.codec import encode_jax as ej

from tpu_deflate_torch.codec import emit as em
from tpu_deflate_torch.codec import encode as pe

S_REF = 65536
FIELDS = ("litlen_sym", "flags", "len_eb", "len_ev", "dist_sym", "dist_eb", "dist_ev")
SEG = em.EMIT_SEGMENT
BUF_WORDS = SEG * 48 // 32 + 1  # BUF_WORDS in csrc/emit.cu
W = em.EMIT_WORDS
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The plain version against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch() -> dict:
    """The reference's analysis of three lanes: text (routed dynamic), 60
    printable bytes (fixed) and random bytes (stored)."""
    rng = np.random.default_rng(21)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(80)]
    padded = np.zeros((3, S_REF), np.uint8)
    padded[0] = np.concatenate([words[i] for i in rng.integers(0, 80, 30000)])[:S_REF]
    padded[1, :60] = rng.integers(33, 127, 60)
    padded[2] = rng.integers(0, 256, S_REF)
    lengths = np.array([S_REF, 60, S_REF], np.int32)
    a = ej.analyze_device(jnp.asarray(padded), jnp.asarray(lengths), True, 0)
    return {"a": a, "lengths": lengths}


FINALS = {"none": None, "zeros": np.zeros(3, np.int32), "mixed": np.array([1, 0, 1], np.int32)}


@pytest.mark.parametrize("final_kind", list(FINALS))
def test_plain_matches_plan_codes_and_pallas_emit(batch, final_kind):
    a, lengths, final = batch["a"], batch["lengths"], FINALS[final_kind]
    ref = ej._plan_codes(a, lengths.astype(np.int64), 3, final)
    flags = np.asarray(a["is_token"]).astype(np.int32) | (np.asarray(a["is_match"]).astype(np.int32) << 1)
    fields = [flags if k == "flags" else np.asarray(a[k]).astype(np.int32) for k in FIELDS]
    rw, rtot = ep.emit_device_pallas(*(jnp.asarray(f) for f in fields), *ref[:6], interpret=True)

    hist = {k: torch.from_numpy(np.asarray(a[k]).astype(np.int32)) for k in ("litlen_hist", "dist_hist")}
    plan = pe._plan_codes(hist, lengths, final)
    got = em.emit_routed(*(torch.from_numpy(f) for f in fields), *plan)
    assert len(got) == 6
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.asarray(rw))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(rtot))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[6]))
    assert got[2].tolist() == [pe.ROUTE_DYNAMIC, pe.ROUTE_FIXED, pe.ROUTE_STORED]


# ---------------------------------------------------------------------------
# The mirror of the kernel's blocks
# ---------------------------------------------------------------------------


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _shl(x: np.ndarray, n: np.ndarray) -> np.ndarray:
    """uint32 x << n, 0 for a count outside [0, 32) (td::shl_u)."""
    ok = (n >= 0) & (n < 32)
    return np.where(ok, ((x & M32) << np.where(ok, n, 0)) & M32, 0)


def _route(lane: int, r: tuple) -> tuple:
    """A block's routing of its lane: (choice, dynamic, fixed, stored)."""
    ll_hist, d_hist, ll_len, d_len, hdr, lengths = r[:6]
    s, k = np.arange(288), np.arange(30)
    ll_extra = np.where((s >= 265) & (s <= 284), (s - 261) >> 2, 0)
    flen = np.where(s < 144, 8, np.where(s < 256, 9, np.where(s < 280, 7, 8)))
    d_extra = np.where(k >= 4, (k >> 1) - 1, 0)
    hl, hd = ll_hist[lane].astype(np.int64) & M32, d_hist[lane].astype(np.int64) & M32

    def dot(h, x):
        return int((((h * (np.asarray(x, np.int64) & M32)) & M32)).sum()) & M32

    e = (dot(hl, ll_extra) + dot(hd, d_extra)) & M32
    dyn = _i32(int(hdr[lane]) + dot(hl, ll_len[lane]) + dot(hd, d_len[lane]) + e + int(ll_len[lane, 256]))
    fixed = _i32(3 + dot(hl, flen) + dot(hd, np.full(30, 5)) + e + 7)
    n = int(lengths[lane])
    q = _i32(n + 65534) // 65535
    stored = _i32(8 * ((n & M32) + 5 * (q & M32) + 1))
    choice = pe.ROUTE_STORED if stored < min(dyn, fixed) else (pe.ROUTE_FIXED if fixed < dyn else pe.ROUTE_DYNAMIC)
    return choice, dyn, fixed, stored


def _or_part(out: np.ndarray, limit: int, off: int, v: int) -> None:
    """OR a value's low and high word parts at bit off; parts past [0,
    limit) dropped, parts of 0 not written."""
    w, sh = off >> 5, off & 31
    lo = (v << sh) & M32
    hi = (v >> (32 - sh)) & M32 if sh else 0
    for word, part in ((w, lo), (w + 1, hi)):
        if part and 0 <= word < limit:
            out[word] |= part


def _segment(lane: int, seg: int, fields: tuple, ll_tab: np.ndarray, d_tab: np.ndarray) -> dict:
    """A block's slots: values, bits and offsets inside the segment in
    position order, its bit count and whether it takes the direct path."""
    S = fields[0].shape[1]
    p = np.arange(seg * SEG, min(S, (seg + 1) * SEG))
    sym, flags, leb, lev, dsym, deb, dev = (f[lane, p].astype(np.int64) for f in fields)
    tok, match = (flags & 1) != 0, (flags & 2) != 0
    ll = np.where(tok, ll_tab[np.clip(sym, 0, 287)], 0)
    dd = d_tab[np.clip(dsym, 0, 29)]
    b0, b2 = ll >> 16, dd >> 16
    va = np.where(match, (ll & 0xFFFF) | _shl(lev, b0), ll & 0xFFFF)
    ba = np.where(match, b0 + leb, b0)
    vb = np.where(match, (dd & 0xFFFF) | _shl(dev, b2), 0)
    bb = np.where(match, b2 + deb, 0)
    vals = np.stack([va, vb], axis=1).reshape(-1)
    bits = np.stack([ba, bb], axis=1).reshape(-1)
    unpackable = (bits != 0) & ((bits < 0) | (bits > 31) | ((vals >> np.clip(bits, 0, 63)) != 0))
    agg = int(bits.sum())
    direct = bool(unpackable.any()) or agg > 32 * (BUF_WORDS - 1)
    return {"vals": vals, "bits": bits, "offs": np.cumsum(bits) - bits, "agg": agg, "direct": direct}


def _write_body(out: np.ndarray, blk: dict, start: int) -> None:
    """A block's body words: slot by slot (direct), or its buffer shifted to
    its first bit, the first and last word ORed, the words between stored."""
    if blk["direct"]:
        for v, b, off in zip(blk["vals"], blk["bits"], blk["offs"]):
            if b > 0:
                _or_part(out, W, start + int(off), int(v))
        return
    agg = blk["agg"]
    if agg <= 0:
        return
    buf = np.zeros(BUF_WORDS + 1, np.int64)
    for v, b, off in zip(blk["vals"], blk["bits"], blk["offs"]):
        if b > 0:
            _or_part(buf, BUF_WORDS, int(off), int(v))
    sh, w0 = start & 31, start >> 5
    nout = (sh + agg + 31) >> 5
    for k in range(nout):
        gw = w0 + k
        if not 0 <= gw < W:
            continue
        v = (int(buf[k]) << sh | (int(buf[k - 1]) >> (32 - sh) if k and sh else 0)) & M32
        if k == 0 or k == nout - 1:
            out[gw] |= v
        else:
            out[gw] = v


def mirror_emit(args: tuple, seed: int) -> tuple:
    """The kernel over ``emit_routed``'s 22 NumPy arguments (routing on) or
    ``emit_device``'s 13 (off) -> (words int32, total bits int32, the four
    costs or None)."""
    rng = np.random.default_rng(seed)
    routed = len(args) == 22
    fields = args[:7]
    if routed:
        r = args[7:13]
        llc, dc, hv, hb, ev, eb, fix_ll, fix_d, final = args[13:]
    else:
        llc, dc, hv, hb, ev, eb = args[7:]
    L, S = fields[0].shape
    nseg = -(-S // SEG)
    out = np.zeros((L, W), np.int64)
    total = np.zeros(L, np.int64)
    costs = np.zeros((4, L), np.int64)
    blocks = {}
    for lane in range(L):
        route = _route(lane, r) if routed else (pe.ROUTE_DYNAMIC,)
        fixed = route[0] == pe.ROUTE_FIXED
        if routed:
            costs[:, lane] = route
        ll_tab = (fix_ll[0] if fixed else llc[lane]).astype(np.int64)
        d_tab = (fix_d[0] if fixed else dc[lane]).astype(np.int64)
        header_len = 3 if fixed else int(hb[lane].sum())
        start = header_len  # the look-back: the header's length plus the earlier segments' bits
        for seg in range(nseg):
            blk = _segment(lane, seg, fields, ll_tab, d_tab)
            blocks[lane, seg] = (blk, start, fixed)
            start += blk["agg"]
    order = list(blocks.items())
    for i in rng.permutation(len(order)):
        (lane, seg), (blk, start, fixed) = order[i]
        row = out[lane]
        if seg == 0 and fixed:
            _or_part(row, W, 0, (1 if final is None else int(final[lane])) | 2)
        elif seg == 0:
            offs = np.cumsum(hb[lane].astype(np.int64)) - hb[lane]
            for v, b, off in zip(hv[lane], hb[lane], offs):
                if b > 0:
                    _or_part(row, W, int(off), int(v))
        if seg == nseg - 1:
            end = start + blk["agg"]
            e = 7 if fixed else int(eb[lane])
            if e > 0:
                _or_part(row, W, end, 0 if fixed else int(ev[lane]))
            total[lane] = _i32(end + e)
        _write_body(row, blk, start)
    words = (((out + (1 << 31)) & M32) - (1 << 31)).astype(np.int32)
    return words, total.astype(np.int32), costs.astype(np.int32) if routed else None


def _plain(args: tuple) -> tuple:
    t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    out = em.emit_routed_plain(*t) if len(args) == 22 else em.emit_device_plain(*t)
    return tuple(x.numpy() for x in out)


def _assert_mirror(args: tuple, seeds=(0, 1, 2)) -> tuple:
    want = _plain(args)
    for seed in seeds:
        words, total, costs = mirror_emit(args, seed)
        np.testing.assert_array_equal(words, want[0])
        np.testing.assert_array_equal(total, want[1])
        if costs is not None:
            np.testing.assert_array_equal(costs, np.stack(want[2:]))
    return want


LEB_LONG = 40  # a slot of more than 31 bits: its segment takes the direct path


def edge_lanes(final_kind: str) -> tuple:
    """``emit_routed``'s arguments for eight lanes of 2 segments + 1024
    positions, each routed by its planned header's bits and member length
    (histograms all 0, so dynamic = hdr_bits + 8, fixed = 10):

    0. FIXED (hdr_bits 2000): its dynamic header (2000 bits) is longer
       than its body of 5 literals;
    1. dynamic, a header of three 32-bit slots (ends on a word boundary);
    2. dynamic, a header of 77 bits (ends inside segment 0's first word);
    3. STORED (member length 0), an empty body;
    4. dynamic, segment 1 on the direct path;
    5. dynamic, the EOB straddling the grid's end;
    6. dynamic, the EOB past the grid;
    7. dynamic, member length 1, random tokens;

    member lengths 65535 and 65536 in the others."""
    rng = np.random.default_rng(7)
    L, S = 8, 2 * SEG + 1024
    fields = chip_smoke.random_tokens(rng, L, S)
    sym, flags, leb, lev, dsym, deb, dev = fields
    for a in fields:
        a[[0, 3, 5, 6]] = 0
    flags[0, 100:105], sym[0, 100:105] = 1, rng.integers(0, 256, 5)
    flags[4, SEG + 7], sym[4, SEG + 7], leb[4, SEG + 7], lev[4, SEG + 7] = 3, 265, LEB_LONG, 12345
    hb = rng.integers(0, 17, (L, 384)).astype(np.int32)
    hb[1], hb[1, :3] = 0, 32
    hb[2], hb[2, :7] = 0, 11
    hb[0], hb[0, :125] = 0, 16
    hv = rng.integers(0, 2**32, (L, 384)) & ((1 << hb) - 1)
    eb = rng.integers(1, 16, L).astype(np.int32)
    ev = rng.integers(0, 2**32, L) & ((1 << eb) - 1)
    ll_len = rng.integers(1, 16, (L, 288)).astype(np.int32)
    ll_len[:, 256] = 8
    llc = ((ll_len << 16) | (rng.integers(0, 1 << 15, (L, 288)) & ((1 << ll_len) - 1))).astype(np.int32)
    d_n = rng.integers(1, 16, (L, 30))
    dc = ((d_n << 16) | (rng.integers(0, 1 << 15, (L, 30)) & ((1 << d_n) - 1))).astype(np.int32)
    # Lanes 5 and 6: a body of one literal, then one slot of the length
    # that puts the EOB 3 bits before the grid's end, and 77 bits past it.
    for lane, end in ((5, 32 * W - 3), (6, 32 * W + 77)):
        codes = (int(llc[lane, 0]) >> 16) + (int(llc[lane, 257]) >> 16) + (int(dc[lane, 0]) >> 16)
        flags[lane, 0], sym[lane, 0] = 1, 0
        flags[lane, 1], sym[lane, 1], leb[lane, 1] = 3, 257, end - int(hb[lane].sum()) - codes
    eb[5], ev[5] = 7, 0x7F
    hdr = np.zeros(L, np.int32)
    hdr[0], hdr[3] = 2000, 100
    lengths = np.array([1000, 65535, 65536, 0, 65536, 65535, 65536, 1], np.int32)
    fl, fd = pe._fixed_code_tables()
    final = {"none": None, "zeros": np.zeros(L, np.int64), "mixed": (np.arange(L) % 2).astype(np.int64)}[final_kind]
    return (*fields, np.zeros((L, 288), np.int32), np.zeros((L, 30), np.int32), ll_len,
            np.zeros((L, 30), np.int32), hdr, lengths, llc, dc, hv, hb, ev, eb, fl, fd, final)


@pytest.mark.parametrize("final_kind", ["none", "zeros", "mixed"])
def test_mirror_matches_plain_on_edge_lanes(final_kind):
    args = edge_lanes(final_kind)
    words, total, choice, *_costs = _assert_mirror(args)
    assert choice.tolist() == [1, 0, 0, 2, 0, 0, 0, 0]
    hb, eb = args[16], args[18]
    header = hb.sum(axis=1)
    assert header[1] % 32 == 0 and header[2] % 32 != 0  # the header ends on a word, inside a word
    assert header[0] > 5 * 9  # the FIXED lane's dynamic header, longer than its body
    assert 3 + 5 * 8 + 7 <= total[0] <= 3 + 5 * 9 + 7
    assert total[3] == header[3] + eb[3]  # the empty body
    grid = 32 * W
    assert total[5] - eb[5] == grid - 3 and total[6] - eb[6] == grid + 77
    assert (int(words[5, -1]) & M32) >> 29 == 0x7  # the EOB's first 3 bits end the grid
    for lane, seg in ((4, 1), (5, 0)):
        assert _segment(lane, seg, args[:7], args[13][lane].astype(np.int64), args[14][lane].astype(np.int64))["direct"]


@pytest.mark.parametrize("final_kind", ["none", "zeros", "mixed"])
def test_mirror_matches_plain_on_routing_edge_lanes(final_kind):
    """The smoke's routing edge lanes (ties, every strategy, member lengths
    0, 1, 65535 and 65536) on its short token row."""
    arrays, final = chip_smoke.routed_edge_lanes(16, seed=len(final_kind), final_kind=final_kind)
    want = _assert_mirror((*arrays, final), seeds=(0,))
    assert set(want[2].tolist()) == {pe.ROUTE_DYNAMIC, pe.ROUTE_FIXED, pe.ROUTE_STORED}


def test_mirror_matches_plain_on_header_eob_edge_lanes():
    """The smoke's header/EOB edge lanes: 32-bit slots on words, 1-bit
    slots, 0-bit slots and EOBs, an empty body, segment 0 on the direct
    path, an EOB straddling the grid's end, at its last bit and past it."""
    args = chip_smoke.header_eob_edge_lanes(12, seed=5)
    _words, total = _assert_mirror(args, seeds=(0,))
    grid = 32 * W
    body = total - args[12] - args[10].sum(axis=1)
    assert (body == 0).any() and (total > grid).any() and (body > 2 * 48 * SEG).any()


# ---------------------------------------------------------------------------
# The wrappers on CPU tensors
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_versions_on_the_cpu():
    arrays, final = chip_smoke.routed_edge_lanes(8, seed=3, final_kind="mixed")
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*arrays, final)]
    before = dict(em.ENCODE_LAUNCHES)
    got = em.emit_routed(*t)
    dev = em.emit_device(*t[:7], *em.route_plain(*t[7:])[:6])
    assert em.ENCODE_LAUNCHES == before
    want = em.emit_routed_plain(*t)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(dev[0], got[0]) and torch.equal(dev[1], got[1])
    with pytest.raises(ValueError):
        em.emit_routed(*t[:15], t[15].to(torch.int32), *t[16:])
    with pytest.raises(ValueError):
        em.emit_routed(*t[:21], t[21].to(torch.int32))
    with pytest.raises(ValueError):
        em.emit_routed(*(x.to(torch.int64) for x in t[:7]), *t[7:])
    with pytest.raises(ValueError):
        em.emit_device(*(x[:, :1000].contiguous() for x in t[:7]), *em.route_plain(*t[7:])[:6])
