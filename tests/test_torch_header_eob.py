"""The block header and EOB of the encoder's emit (``emit.header_eob``; on
the card segment 0's and the last segment's blocks of the emit's one
launch in csrc/emit.cu place them) on the CPU: the plain spec
``header_eob_words_plain`` against the JAX package's jitted
``emit_pallas._header_eob_words``, then a NumPy mirror of the placement
against ``body | header_eob_words_plain``.

The mirror follows the kernel: in segment 0's block of a lane, the 480
threads of warps 1-15 (warp 0 runs the look-back meanwhile), thread t
taking H / 480 (rounded up) consecutive header slots; each slot's bit
offset from an exclusive scan of the threads' bit counts (a warp shuffle
scan, then the warp totals before it); every slot of more than 0 bits ORed
at its offset into the body's words as a low part and, where it crosses a
word, a high part, a part past the grid dropped; the EOB at the body's end;
total bits = body end + EOB bits. The threads' ORs run in a random order.
Inputs are the smoke's own edge lanes (``chip_smoke.header_eob_edge_inputs``:
32-bit slots on words, 1-bit slots, 0-bit slots with values that must not
land, an EOB at the header's end, straddling the grid's last word, at its
last bit, past the grid and of 0 bits) and H other than 384. Integer-only,
so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import emit_pallas as ep

from tpu_deflate_torch.codec import emit as em

THREADS = 480  # the threads of warps 1-15 of a 512-thread block in csrc/emit.cu
M32 = 0xFFFFFFFF


def _inputs(L: int, seed: int) -> tuple:
    return chip_smoke.header_eob_edge_inputs(L, seed)


def _plain_words(he: tuple) -> tuple:
    words, total = em.header_eob_words_plain(*(torch.from_numpy(a) for a in he))
    return words.numpy(), total.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_words_plain_match_reference(seed):
    _words, hv, hb, ev, eb, body_end = _inputs(12, seed)
    rw, rtot = ep._header_eob_words(jnp.asarray(hv.astype(np.uint32)), jnp.asarray(hb),
                                    jnp.asarray(ev.astype(np.uint32)), jnp.asarray(eb), jnp.asarray(body_end))
    words, total = _plain_words((hv, hb, ev, eb, body_end))
    np.testing.assert_array_equal(words.view(np.uint32), np.asarray(rw))
    np.testing.assert_array_equal(total, np.asarray(rtot))
    grid = 32 * em.EMIT_WORDS
    assert (body_end >= grid).any() and (total > grid).any()  # an EOB past the grid, dropped


def mirror_header_eob(words: np.ndarray, hv, hb, ev, eb, body_end, seed: int = 0) -> tuple:
    """The kernel over a copy of ``words`` (L, EMIT_WORDS) int32."""
    rng = np.random.default_rng(seed)
    L, H = hb.shape
    W = em.EMIT_WORDS
    out = words.astype(np.int64) & M32
    per = -(-H // THREADS)

    def place(lane, off, val):
        w, sh = off >> 5, off & 31
        lo = (val << sh) & M32
        hi = (val >> (32 - sh)) & M32 if sh else 0  # a slot ending inside its word has no high part
        for word, part in ((w, lo), (w + 1, hi)):
            if part and 0 <= word < W:  # past the grid: dropped
                out[lane, word] |= part

    total = np.empty(L, np.int64)
    for lane in range(L):
        mine = np.array([hb[lane, t * per : (t + 1) * per].sum() for t in range(THREADS)], np.int64)
        incl = np.zeros(THREADS, np.int64)
        for wid in range(THREADS // 32):  # the shuffle scan inside each warp, then the warps before
            w = mine[32 * wid : 32 * wid + 32]
            incl[32 * wid : 32 * wid + 32] = np.cumsum(w) + sum(mine[: 32 * wid])
        start = incl - mine
        for t in rng.permutation(THREADS):
            off = int(start[t])
            for j in range(min(H, t * per), min(H, (t + 1) * per)):
                b = int(hb[lane, j])
                if b > 0:
                    place(lane, off, int(hv[lane, j]))
                off += b
        if eb[lane] > 0:
            place(lane, int(body_end[lane]), int(ev[lane]))
        total[lane] = int(body_end[lane]) + int(eb[lane])
    wrap = ((out + (1 << 31)) & M32) - (1 << 31)
    return wrap.astype(np.int32), total.astype(np.int32)


@pytest.mark.parametrize("H", [384, 100, 129])
def test_mirror_matches_plain(H):
    words, hv, hb, ev, eb, body_end = _inputs(12, seed=H)
    hv, hb = np.ascontiguousarray(hv[:, :H]), np.ascontiguousarray(hb[:, :H])
    got = mirror_header_eob(words, hv, hb, ev, eb, body_end, seed=H)
    he_words, total = _plain_words((hv, hb, ev, eb, body_end))
    np.testing.assert_array_equal(got[0], words | he_words)
    np.testing.assert_array_equal(got[1], total)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    he = tuple(torch.from_numpy(a) for a in _inputs(6, seed=3))
    before = dict(em.ENCODE_LAUNCHES)
    words, total = em.header_eob(*he)
    assert em.ENCODE_LAUNCHES == before
    want = em.header_eob_plain(*he)
    assert torch.equal(words, want[0]) and torch.equal(total, want[1])
    with pytest.raises(ValueError):
        em.header_eob(he[0], he[1].to(torch.int32), *he[2:])
