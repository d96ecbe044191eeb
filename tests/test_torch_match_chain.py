"""The match finder's same-hash links (``encode.match_chain``) and the
candidate compare that walks them (``encode.match_bucket``) on the CPU,
where both run their plain versions:

- the links' k-th hop is the k-th entry before a position in its hash
  group of the reference's stable ``lax.sort`` (the grouping of
  ``encode_jax._match_find``'s ``bucket_best``);
- the compare on the links equals the sorted-space compare the port ran
  before (``match_find_cases._bucket_best_before``) for every family and
  quality;
- ``match_find_cases.chain_mirror``, the chain kernel's walk step for step
  (its split into hash parts, 16-bit heads and their rewrite every epoch), equals the
  plain links on both batches, on a row of 98304 columns whose hashes recur
  exactly 65536 and 65537 columns apart (where 16-bit heads alias unless
  their stale entries are rewritten: the mirror without the rewrite gets
  them wrong) and on a row of long chains across every epoch.

The bucket kernel's mirror runs in ``match_find_cases.test_bucket_mirror``
at each quality."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import match_find_cases as mc
from match_find_cases import _one_torch_thread  # noqa: F401  (fixture)
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.codec.decode_kernels import wrap_int32

S_LONG = 98304


@functools.cache
def finder(quality: int) -> mc.MatchFind:
    return mc.MatchFind(quality)


def _hops(links: np.ndarray, k_max: int):
    """Each position's hops along the links (R, S): yields (k, alive, cand)
    for k = 1..k_max, cand the k-th hop where alive."""
    R, S = links.shape
    rows = np.arange(R)[:, None]
    cand = np.broadcast_to(np.arange(S), (R, S)).copy()
    alive = np.ones((R, S), bool)
    for k in range(1, k_max + 1):
        d = links[rows, cand].astype(np.int64)
        alive &= d > 0
        cand = np.where(alive, cand - d, cand)
        yield k, alive, cand


@pytest.mark.parametrize("name", mc.BATCHES)
def test_hops_are_the_reference_groups(name):
    """Hop k of a position is the k-th entry before it in its group of the
    reference's stable sort, wherever that entry lies at most MAX_DIST
    back; and every hop is such an entry."""
    keys = finder(1).keys(name).numpy()
    F, L, S = keys.shape
    h = jnp.asarray(keys.reshape(F * L, S))
    si = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], h.shape)
    sorted_h, order = (np.asarray(a) for a in jax.lax.sort((h, si), dimension=1, is_stable=True, num_keys=1))
    changed = np.ones(sorted_h.shape, bool)
    changed[:, 1:] = sorted_h[:, 1:] != sorted_h[:, :-1]
    col = np.arange(S)[None, :]
    rank = col - np.maximum.accumulate(np.where(changed, col, -1), axis=1)
    rows = np.arange(F * L)[:, None]
    links = finder(1).links(name).numpy().reshape(F * L, S)
    k_max = max(q["K4"] for q in pe._QUALITY.values())
    for k, alive, cand in _hops(links, k_max):
        ref = np.full((F * L, S), -1, np.int64)
        ref[rows, order] = np.where((rank >= k) & (sorted_h != -1), np.roll(order, k, axis=1), -1)
        near = (ref >= 0) & (col - ref <= mc.MAX_DIST)
        assert (alive <= (ref >= 0)).all(), f"hop {k}: a hop where the group has none"
        assert (near <= alive).all(), f"hop {k}: a group entry within reach not hopped to"
        assert np.array_equal(cand[alive], ref[alive]), f"hop {k}"


@pytest.mark.parametrize("quality", sorted(pe._QUALITY))
@pytest.mark.parametrize("name", mc.BATCHES)
def test_bucket_equals_sorted_space(name, quality):
    """The compare along the links equals the sorted-space compare it
    replaced, family by family."""
    mf = finder(quality)
    data = mc.torch_args(name)[0]
    w32i = wrap_int32(pe._u32_windows(data)).to(torch.int32)
    keys, links = mf.keys(name), mf.links(name)
    for i, (fam, k, w) in enumerate(mf.families()):
        want = mc._bucket_best_before(keys[i], w32i, k, w)
        got = pe._bucket_best_plain(links[i : i + 1].contiguous(), data, (k,), (w,))[0]
        assert torch.equal(got, want), f"family {fam}"
        assert torch.equal(mf.packs(name)[fam], want), f"family {fam}, all families at once"


@pytest.mark.parametrize("name", mc.BATCHES)
def test_chain_mirror(name):
    """The chain kernel's walk equals the plain links (three families)."""
    keys = finder(1).keys(name)
    assert np.array_equal(mc.chain_mirror(keys.numpy()), pe.match_chain(keys).numpy())


def _recurrence_row() -> tuple[np.ndarray, dict]:
    """Keys (1, 1, S_LONG): random hashes from a set without the four
    hashes below, each of which occurs twice only, this many columns apart;
    a stretch of -1 keys; {column of the second occurrence: its link}."""
    rng = np.random.default_rng(151)
    apart = {65536: 0, 65537: 0, 32768: 32768, 32769: 0}
    special = {11, 22, 33, 44}
    pool = np.array(sorted(set(range(4096)) - special), np.int32)
    row = pool[rng.integers(0, pool.size, S_LONG)]
    row[70000:70500] = -1
    want = {}
    for (gap, link), hv, at in zip(apart.items(), sorted(special), (1000, 3000, 40000, 50000)):
        row[at] = row[at + gap] = hv
        want[at + gap] = link
    return row[None, None, :], want


def test_recurrence_65536_65537():
    """A hash recurring exactly 65536 or 65537 columns apart (or 32769) has
    no link, one recurring 32768 apart has; the mirror agrees with the
    plain links everywhere, and the same walk without the rewrite of stale
    heads links the 65537 recurrence to 1 column back (16-bit aliasing)."""
    keys, want = _recurrence_row()
    plain = pe.match_chain(torch.from_numpy(keys)).numpy()
    assert {c: int(plain[0, 0, c]) for c in want} == want
    assert np.array_equal(mc.chain_mirror(keys), plain)
    aliased = mc.chain_mirror(keys, rewrite=False)
    assert int(aliased[0, 0, 3000 + 65537]) == 1


def test_long_chains_across_epochs():
    """Two rows of 98304 columns whose keys take 64 values (every link
    short, chains of ~1500 positions across every epoch) and 40000 values
    (links of every length up to the limit and past it), with a history
    start and a lane end (-1 keys before and after)."""
    rng = np.random.default_rng(152)
    keys = np.stack([rng.integers(0, 64, S_LONG), rng.integers(0, 40000, S_LONG)]).astype(np.int32)
    keys[0, :12345] = -1
    keys[1, 90001:] = -1
    keys = keys[:, None, :]
    plain = pe.match_chain(torch.from_numpy(keys)).numpy()
    far = plain[1].astype(np.int64)
    assert (far > 16384).any() and (far == 0).sum() > 8000
    assert np.array_equal(mc.chain_mirror(keys), plain)
