"""Batched length-limited Huffman code lengths on the host (a copy, trimmed,
of ``huffman_lengths_batch`` in ``tpu_deflate.kernels.huffman``).

The device encoder plans the codes of all lanes of a batch at once here,
between its analyze and emit phases, as the reference does.
"""

from __future__ import annotations

import numpy as np


def huffman_lengths_batch(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Code lengths for many histograms at once.

    Lock-step two-queue Huffman (leaves presorted; merged nodes emerge in
    nondecreasing cost order), one merge per step for every lane; depths
    propagate root to leaf; lengths above ``max_len`` are repaired with the
    zlib-style bl_count adjustment.

    freqs: (L, N) int64. Lanes with 0 used symbols get all-zero lengths;
    lanes with 1 used symbol get that symbol at length 1. Returns (L, N)
    int32 lengths forming complete codes (for >= 2 used symbols).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    L, N = freqs.shape
    INF = np.int64(1) << 60
    lanes = np.arange(L)

    f = np.where(freqs > 0, freqs, INF)
    order = np.argsort(f, axis=1, kind="stable")
    sf = np.take_along_axis(f, order, axis=1)
    n_used = (freqs > 0).sum(axis=1)
    merges = np.maximum(n_used - 1, 0)

    q2cost = np.full((L, N), INF, dtype=np.int64)
    parent = np.full((L, 2 * N), -1, dtype=np.int32)
    h1 = np.zeros(L, dtype=np.int64)
    h2 = np.zeros(L, dtype=np.int64)
    t2 = np.zeros(L, dtype=np.int64)

    def _heads():
        c1 = np.where(h1 < N, sf[lanes, np.minimum(h1, N - 1)], INF)
        c2 = np.where(h2 < t2, q2cost[lanes, np.minimum(h2, N - 1)], INF)
        return c1, c2

    steps = int(merges.max()) if L else 0
    for s in range(steps):
        active = s < merges
        c1, c2 = _heads()
        take1 = c1 <= c2
        cost_a = np.where(take1, c1, c2)
        id_a = np.where(take1, h1, N + h2).astype(np.int64)
        h1 = h1 + (active & take1)
        h2 = h2 + (active & ~take1)
        c1, c2 = _heads()
        take1 = c1 <= c2
        cost_b = np.where(take1, c1, c2)
        id_b = np.where(take1, h1, N + h2).astype(np.int64)
        h1 = h1 + (active & take1)
        h2 = h2 + (active & ~take1)
        new_id = N + t2
        a_idx = np.nonzero(active)[0]
        q2cost[a_idx, t2[a_idx]] = (cost_a + cost_b)[a_idx]
        parent[a_idx, id_a[a_idx]] = new_id[a_idx]
        parent[a_idx, id_b[a_idx]] = new_id[a_idx]
        t2 = t2 + active

    # Depths of merged nodes, processed in decreasing id (parents first).
    depth = np.zeros((L, 2 * N), dtype=np.int32)
    for j in range(steps - 1, -1, -1):
        nid = N + j
        p = parent[lanes, nid]
        valid = (j < t2) & (p >= 0)
        v_idx = np.nonzero(valid)[0]
        depth[v_idx, nid] = depth[v_idx, p[v_idx]] + 1
    leaf_parent = parent[:, :N]
    leaf_depth = np.where(
        leaf_parent >= 0,
        np.take_along_axis(depth, np.maximum(leaf_parent, 0).astype(np.int64), axis=1) + 1,
        0,
    ).astype(np.int64)

    # bl_count with clamping at max_len, then exact Kraft repair: each move
    # (one leaf from depth b to b+1, pairing it with a relocated max-depth
    # leaf) frees exactly one depth-max_len slot.
    clamped = np.minimum(leaf_depth, max_len)
    clamped = np.where(leaf_parent >= 0, clamped, 0)
    bl_count = np.zeros((L, max_len + 1), dtype=np.int64)
    for l in range(1, max_len + 1):
        bl_count[:, l] = (clamped == l).sum(axis=1)
    slot_w = np.int64(1) << (max_len - np.arange(max_len + 1))
    slot_w[0] = 0
    full = np.int64(1) << max_len
    needed = (bl_count * slot_w[None, :]).sum(axis=1)
    needed = np.where(merges > 0, needed, full)  # degenerate lanes: skip
    while (needed > full).any():
        act = needed > full
        # highest bits < max_len with bl_count > 0
        bits = np.zeros(L, dtype=np.int64)
        found = np.zeros(L, dtype=bool)
        for b in range(max_len - 1, 0, -1):
            sel = act & ~found & (bl_count[:, b] > 0)
            bits[sel] = b
            found |= sel
        a_idx = np.nonzero(act & found)[0]
        bl_count[a_idx, bits[a_idx]] -= 1
        bl_count[a_idx, bits[a_idx] + 1] += 2
        bl_count[a_idx, max_len] -= 1
        needed = needed - np.where(act & found, 1, 0)

    # Reassign lengths: ascending-frequency used symbols get descending
    # lengths according to bl_count (lane-major repeat trick).
    lens_desc = np.arange(max_len, 0, -1)
    rep_counts = bl_count[:, ::-1][:, :max_len]  # counts for max_len..1
    flat_lens = np.repeat(np.tile(lens_desc, L), rep_counts.ravel())
    lane_totals = rep_counts.sum(axis=1)
    starts = np.concatenate([[0], np.cumsum(lane_totals)[:-1]])

    lengths = np.zeros((L, N), dtype=np.int32)
    for l_i in range(L):
        if int(n_used[l_i]) == 1:
            lengths[l_i, order[l_i, 0]] = 1
            continue
        cnt = int(lane_totals[l_i])
        if cnt == 0:
            continue
        assigned = flat_lens[starts[l_i] : starts[l_i] + cnt]
        lengths[l_i, order[l_i, :cnt]] = assigned
    return lengths
