"""The port's word packer (tpu_deflate_torch.codec.emit: plain K10,
header_eob_words, emit_device on CPU tensors) against the JAX package's
emit_pallas, whose Pallas kernel runs in interpret mode, and against the
XLA emit encode_jax.emit_device. The lanes come from the reference's own
analyze_device + _plan_codes (as tests/test_device_codec.py::
test_emit_pallas_matches_xla_emit makes them): a text lane routed dynamic,
a short printable lane routed FIXED, and a synthetic lane whose every
literal has a 15-bit code, whose bits overflow the word grid. The emit is
integer-only, so every comparison is exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import emit_pallas as ep
from tpu_deflate.codec import encode_jax as ej
from tpu_deflate_torch.codec import emit as em
from tpu_deflate_torch.codec import encode_np

S = 65536
FIELDS = ("litlen_sym", "flags", "len_eb", "len_ev", "dist_sym", "dist_eb", "dist_ev")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overflow_lane() -> dict:
    """Every position a literal with a 15-bit code: 65536 x 15 bits, past
    the 22528-word grid."""
    rng = np.random.default_rng(4)
    lane = {k: np.zeros((1, S), np.int32) for k in FIELDS}
    lane["litlen_sym"][0] = rng.integers(0, 256, S)
    lane["flags"][0] = 1
    ll = encode_np.pack_codes(np.full((1, 288), 15, np.int64), 15)
    lane["ll_c"] = ll
    lane["d_c"] = np.zeros((1, 30), np.int32)
    lane["ev"] = (ll[:, 256] & 0xFFFF).astype(np.uint32)
    lane["eb"] = (ll[:, 256] >> 16).astype(np.int32)
    return lane


@pytest.fixture(scope="module")
def lanes() -> dict:
    """numpy emit inputs of three lanes: dynamic text, FIXED, overflow."""
    rng = np.random.default_rng(9)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(80)]
    text = np.concatenate([words[i] for i in rng.integers(0, 80, 30000)])[:S]
    short = rng.integers(33, 127, 60, dtype=np.uint8)  # fixed codes beat a dynamic header
    padded = np.zeros((2, S), np.uint8)
    padded[0] = text
    padded[1, :60] = short
    lengths = np.array([S, 60], np.int32)
    a = ej.analyze_device(jnp.asarray(padded), jnp.asarray(lengths), True, 0)
    ll_c, d_c, hv, hb, ev, eb, choice = ej._plan_codes(a, lengths.astype(np.int64), 2)
    assert np.asarray(choice).tolist() == [ej.ROUTE_DYNAMIC, ej.ROUTE_FIXED]
    flags = np.asarray(a["is_token"]).astype(np.int32) | (np.asarray(a["is_match"]).astype(np.int32) << 1)
    out = {k: np.asarray(a[k]).astype(np.int32) for k in FIELDS if k != "flags"}
    out["flags"] = flags
    out.update(ll_c=np.asarray(ll_c), d_c=np.asarray(d_c), hv=np.asarray(hv), hb=np.asarray(hb),
               ev=np.asarray(ev), eb=np.asarray(eb))
    ov = _overflow_lane()
    ov["hv"], ov["hb"] = out["hv"][:1], out["hb"][:1]  # the text lane's dynamic header
    return {k: np.concatenate([out[k], ov[k]]) for k in out}


def _args(x: dict) -> tuple:
    return tuple(x[k] for k in (*FIELDS, "ll_c", "d_c", "hv", "hb", "ev", "eb"))


def _torch_args(x: dict) -> tuple:
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    t["hv"] = t["hv"].to(torch.int64)
    t["ev"] = t["ev"].to(torch.int64)
    return _args(t)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def test_grid_width_matches_pallas():
    assert em.EMIT_WORDS == ep.WORD_ROWS * 128


def test_emit_body_matches_pallas_kernel(lanes):
    """Plain K10 against the Pallas kernel itself (_emit_jit), lane by
    lane: the body words (all 22528) and the body's end bit."""
    L = lanes["litlen_sym"].shape[0]
    R = S // 128
    hdr = lanes["hb"].sum(axis=1).astype(np.int32)
    llc = np.pad(lanes["ll_c"], ((0, 0), (0, 384 - 288))).reshape(L, 3, 128)
    dc = np.pad(lanes["d_c"], ((0, 0), (0, 128 - 30))).reshape(L, 1, 128)
    hb8 = np.broadcast_to(hdr[:, None, None], (L, 8, 128))
    rw, rend = ep._emit_jit(*(jnp.asarray(lanes[k].reshape(L, R, 128)) for k in FIELDS),
                            jnp.asarray(llc), jnp.asarray(dc), jnp.asarray(hb8), interpret=True)
    t = {k: torch.from_numpy(lanes[k]) for k in FIELDS}
    words, body_end = em.emit_body(*(t[k] for k in FIELDS), torch.from_numpy(lanes["ll_c"]),
                                   torch.from_numpy(lanes["d_c"]), torch.from_numpy(hdr))
    assert words.dtype == torch.int32 and tuple(words.shape) == (L, em.EMIT_WORDS)
    np.testing.assert_array_equal(body_end.numpy(), np.asarray(rend))
    np.testing.assert_array_equal(_u32(words), np.asarray(rw))
    assert int(body_end[2]) > 32 * em.EMIT_WORDS  # the overflow lane's bits pass the grid


def test_header_eob_words_match_reference(lanes):
    body_end = np.array([5000, 777, 32 * em.EMIT_WORDS - 3], np.int32)  # EOB at the grid's end
    rw, rtot = ep._header_eob_words(jnp.asarray(lanes["hv"]), jnp.asarray(lanes["hb"]),
                                    jnp.asarray(lanes["ev"]), jnp.asarray(lanes["eb"]),
                                    jnp.asarray(body_end))
    a = _torch_args(lanes)
    words, total = em.header_eob_words(a[9], a[10], a[11], a[12], torch.from_numpy(body_end))
    np.testing.assert_array_equal(total.numpy(), np.asarray(rtot))
    np.testing.assert_array_equal(_u32(words), np.asarray(rw))


def test_emit_device_matches_pallas_and_xla(lanes):
    """The whole emit (header, K10 body, EOB) against emit_device_pallas
    (all words) and the XLA emit (the words below ceil(total_bits / 32),
    within the XLA grid's 20736)."""
    words, total = em.emit_device(*_torch_args(lanes))
    args = tuple(jnp.asarray(v) for v in _args(lanes))
    pw, ptot = ep.emit_device_pallas(*args, interpret=True)
    xw, xtot = ej.emit_device(*args)
    np.testing.assert_array_equal(total.numpy(), np.asarray(ptot))
    np.testing.assert_array_equal(total.numpy(), np.asarray(xtot))
    np.testing.assert_array_equal(_u32(words), np.asarray(pw))
    for l, tb in enumerate(total.numpy()):
        nw = min(-(-int(tb) // 32), ej.WORDS_PER_LANE)
        np.testing.assert_array_equal(_u32(words)[l, :nw], np.asarray(xw)[l, :nw])
    # The overflow lane's exact size exceeds the stored bound: assembly frames it stored.
    assert (int(total[2]) + 7) // 8 >= S + 5 * 2 + 1


def test_emit_body_checks_its_inputs(lanes):
    t = {k: torch.from_numpy(lanes[k]) for k in FIELDS}
    hdr = torch.zeros(3, dtype=torch.int32)
    ll, dc = torch.from_numpy(lanes["ll_c"]), torch.from_numpy(lanes["d_c"])
    with pytest.raises(ValueError):
        em.emit_body(*(t[k].to(torch.int64) for k in FIELDS), ll, dc, hdr)
    with pytest.raises(ValueError):
        em.emit_body(*(t[k][:, :1000].contiguous() for k in FIELDS), ll, dc, hdr)
    with pytest.raises(ValueError):
        em.emit_body(*(t[k] for k in FIELDS), ll[:, :30].contiguous(), dc, hdr)
