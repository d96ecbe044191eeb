"""The encoder's block routing (``encode.route``, run on the card as the
prologue of the emit's one launch, ``emit.emit_routed``) on the CPU: the plain versions ``route_strategies_plain`` and
``_apply_route_plain`` against the JAX package's jitted
``encode_jax.route_strategies`` and ``_apply_route``, on the smoke's own
edge lanes (``chip_smoke.route_edge_inputs``: dynamic == fixed, stored ==
dynamic below fixed, member lengths 0, 1, 65535 and 65536, lanes cheapest as
each strategy) with ``final`` None, all 0 and mixed, and on lanes built by
the planner from real histograms. The routing is integer-only, so every
comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import encode_jax as ej

from tpu_deflate_torch.codec import encode as pe


def _reference(arrays: tuple, final) -> tuple:
    """encode_jax's routing of the same lanes: (ll, dd, hv, hb, ev, eb,
    choice, dyn, fixed, stored) as NumPy, the header and EOB values as
    int64 (the port holds the uint32 values in int64)."""
    ll_hist, d_hist, ll_len, d_len, hdr, lengths, llc, dc, hv, hb, ev, eb, fl, fd = arrays
    costs = ej.route_strategies(*(jnp.asarray(a) for a in (ll_hist, d_hist, ll_len, d_len, hdr, lengths)))
    routed = ej._apply_route(costs[0], jnp.asarray(llc), jnp.asarray(dc), jnp.asarray(hv.astype(np.uint32)),
                             jnp.asarray(hb), jnp.asarray(ev.astype(np.uint32)), jnp.asarray(eb), jnp.asarray(fl),
                             jnp.asarray(fd), None if final is None else jnp.asarray(final.astype(np.int32)))
    out = [np.asarray(x) for x in (*routed, *costs)]
    out[2], out[4] = out[2].astype(np.int64), out[4].astype(np.int64)
    return tuple(out)


def _plain(arrays: tuple, final) -> tuple:
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return tuple(t.numpy() for t in pe.route_plain(*args, None if final is None else torch.from_numpy(final)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("final_kind", ["none", "zeros", "mixed"])
def test_plain_matches_reference_on_edge_lanes(final_kind, seed):
    arrays, final = chip_smoke.route_edge_inputs(40, seed=seed, final_kind=final_kind)
    got, want = _plain(arrays, final), _reference(arrays, final)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert set(got[6].tolist()) == {pe.ROUTE_DYNAMIC, pe.ROUTE_FIXED, pe.ROUTE_STORED}


def test_ties_and_lengths_route_as_the_reference_orders_them():
    """dynamic == fixed goes DYNAMIC; stored == dynamic < fixed is not
    STORED; lengths 0 and 1 cost 8 and 56 bits stored, 65535 and 65536 one
    and two stored blocks."""
    arrays, _final = chip_smoke.route_edge_inputs(16, seed=3)
    ll, dd, hv, hb, ev, eb, choice, dyn, fixed, stored = _plain(arrays, None)
    kind = np.arange(16) % 8
    assert (dyn[kind == 0] == fixed[kind == 0]).all() and (choice[kind == 0] == pe.ROUTE_DYNAMIC).all()
    assert (stored[kind == 1] == dyn[kind == 1]).all() and (dyn[kind == 1] < fixed[kind == 1]).all()
    assert (choice[kind == 1] == pe.ROUTE_DYNAMIC).all()
    lengths = arrays[5]
    for n, bits in ((0, 8), (1, 56), (65535, 8 * (65535 + 5 + 1)), (65536, 8 * (65536 + 10 + 1))):
        assert (stored[lengths == n] == bits).all()
    assert (choice[kind == 5] == pe.ROUTE_FIXED).all() and (choice[kind == 6] == pe.ROUTE_DYNAMIC).all()
    f = choice == pe.ROUTE_FIXED
    fl, fd = pe._fixed_code_tables()
    assert (ll[f] == fl).all() and (dd[f] == fd).all() and (hb[f, 1:] == 0).all() and (hv[f, 1:] == 0).all()
    assert (hv[f, 0] == 3).all() and (hb[f, 0] == 3).all() and (ev[f] == 0).all() and (eb[f] == 7).all()
    np.testing.assert_array_equal(ll[~f], arrays[6][~f])
    np.testing.assert_array_equal(hv[~f], arrays[8][~f])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    arrays, final = chip_smoke.route_edge_inputs(8, seed=4, final_kind="mixed")
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    before = dict(pe.ENCODE_LAUNCHES)
    got = pe.route(*args, final=torch.from_numpy(final))
    assert pe.ENCODE_LAUNCHES == before
    for g, w in zip(got, _plain(arrays, final)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        pe.route(*args[:8], args[8].to(torch.int32), *args[9:])


def test_plan_codes_match_reference():
    """The planner (host lengths, codes and headers, one upload) and the
    routing (its plain version, the emit's prologue on the card) on real histograms, with final mixed, against encode_jax's
    _plan_codes on the same analysis."""
    rng = np.random.default_rng(9)
    L, S = 3, 65536
    padded = np.zeros((L, S), np.uint8)
    text = np.frombuffer(b"the quick brown fox jumps over the lazy dog " * 1500, np.uint8)[:S]
    padded[0] = text
    padded[1, :60] = rng.integers(33, 127, 60)
    padded[2] = rng.integers(0, 256, S)
    lengths = np.array([S, 60, S], np.int32)
    final = np.array([1, 0, 1], np.int32)
    a = ej.analyze_device(jnp.asarray(padded), jnp.asarray(lengths), True, 0)
    want = ej._plan_codes(a, lengths.astype(np.int64), 2, final)
    hist = {k: torch.from_numpy(np.asarray(a[k]).astype(np.int32)) for k in ("litlen_hist", "dist_hist")}
    got = pe.route_plain(*pe._plan_codes(hist, lengths, final))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64) if i in (2, 4) else w)
    assert np.asarray(want[6]).tolist() == [pe.ROUTE_DYNAMIC, pe.ROUTE_FIXED, pe.ROUTE_STORED]


def test_upload_keeps_dtypes_and_shapes():
    arrays = (np.arange(7, dtype=np.int32), np.arange(12, dtype=np.int64).reshape(3, 4), np.zeros((2, 3), np.int32))
    for a, t in zip(arrays, pe._upload(torch.device("cpu"), *arrays)):
        assert t.dtype == torch.from_numpy(a).dtype and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
