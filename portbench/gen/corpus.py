"""The benchmark's data set: a Silesia-sized mix of four parts, made from a
seed with NumPy in a few large calls.

The parts and their parameters come from the configuration's ``corpus``
entry; each part is a share of the size, in the order given, and the
last part takes the bytes that rounding leaves. Four kinds:

- ``text``: words of ``word_min``..``word_max`` - 1 lowercase letters
  from a vocabulary of ``words``, drawn by ``zipf_a`` Zipf ranks modulo
  the vocabulary, written back to back; each word's length is the same
  for every seed (drawn once, from ``VOCAB_SEED``), its letters come from
  the seed;
- ``records``: one random record of ``record_bytes`` repeated, each byte
  replaced by a random one with probability ``noise``;
- ``runs``: runs of one of ``values`` byte values, each 1 to
  ``max_run`` bytes long;
- ``random``: uniform bytes.

Every seed gives the same part sizes and the same word lengths, so seeds
change the content and not the amount of work: with lengths drawn from
the seed, the text's mean word length, and with it the ratio and the
decode's tokens, moved by a fifth from seed to seed. The text part is made in chunks of ``CHUNK`` bytes so
that its index arrays stay small.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1 << 24
LUT_BITS = 20
VOCAB_SEED = 0


def part_sizes(total: int, parts: list[dict]) -> list[int]:
    """Bytes of each part: ``share`` of ``total`` rounded down, the last
    part the remainder."""
    sizes = [int(total * float(p["share"])) for p in parts[:-1]]
    return sizes + [total - sum(sizes)]


def zipf_mod(a: float, nwords: int, ranks: int = 1 << 21) -> np.ndarray:
    """Probability of each word id when a Zipf(a) rank (1, 2, ...) is taken
    modulo ``nwords``: ranks below ``ranks`` summed exactly, the tail above
    by its integral, spread evenly over the ids."""
    r = np.arange(1, ranks, dtype=np.float64)
    q = np.bincount((r % nwords).astype(np.int64), weights=r ** -a, minlength=nwords)
    q += ranks ** (1.0 - a) / (a - 1.0) / nwords
    return q / q.sum()


def _text(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    nwords, lo, hi = int(p["words"]), int(p["word_min"]), int(p["word_max"])
    lengths = np.random.default_rng(VOCAB_SEED).integers(lo, hi, nwords).astype(np.int32)
    table = rng.integers(97, 123, (nwords, hi), dtype=np.uint8)
    q = zipf_mod(float(p["zipf_a"]), nwords)
    # Word ids by table lookup of LUT_BITS-bit uniform draws (inverse CDF).
    lut = np.minimum(np.searchsorted(np.cumsum(q), (np.arange(1 << LUT_BITS) + 0.5) / (1 << LUT_BITS)),
                     nwords - 1).astype(np.int32)
    mean_len = float(q @ lengths)
    out = np.empty(n, np.uint8)
    filled = 0
    while filled < n:
        want = min(CHUNK, n - filled)
        ids = np.empty(0, np.int32)
        total = 0
        while total < want:  # a few words more than the mean asks for, topped up if short
            more = lut[rng.integers(0, 1 << LUT_BITS, int((want - total) / mean_len * 1.01) + 64)]
            ids = np.concatenate([ids, more])
            total += int(lengths[more].sum())
        lens = lengths[ids].astype(np.int32)
        ends = np.cumsum(lens, dtype=np.int32)
        k = int(np.searchsorted(ends, want)) + 1
        ids, lens, ends = ids[:k], lens[:k], ends[:k]
        # Index into the flat word table: each word's row start, minus where
        # the word starts in the chunk, plus the position in the chunk.
        flat = np.repeat(ids * hi - (ends - lens), lens)
        flat += np.arange(flat.size, dtype=np.int32)
        out[filled : filled + want] = table.ravel()[flat[:want]]
        filled += want
    return out


def _records(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    rec = rng.integers(0, 256, int(p["record_bytes"]), dtype=np.uint8)
    block = np.resize(rec, n)
    noisy = rng.random(n, dtype=np.float32) < float(p["noise"])
    block[noisy] = rng.integers(0, 256, int(noisy.sum()), dtype=np.uint8)
    return block


def _runs(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    max_run = int(p["max_run"])
    # Mean run (max_run + 1) / 2: draw a fifth more than needed, top up if short.
    out = np.empty(0, np.uint8)
    while out.size < n:
        k = (n - out.size) * 12 // (5 * (max_run + 1)) + 64
        vals = rng.integers(0, int(p["values"]), k, dtype=np.uint8)
        reps = rng.integers(1, max_run + 1, k)
        out = np.concatenate([out, np.repeat(vals, reps)])
    return out[:n]


def _random(rng: np.random.Generator, n: int, _p: dict) -> np.ndarray:
    return rng.integers(0, 256, n, dtype=np.uint8)


KINDS = {"text": _text, "records": _records, "runs": _runs, "random": _random}


def make(total: int, parts: list[dict], seed: int) -> np.ndarray:
    """The data set of ``total`` bytes for ``seed`` (uint8, read-only use)."""
    rng = np.random.default_rng(seed)
    out = np.empty(total, np.uint8)
    at = 0
    for p, n in zip(parts, part_sizes(total, parts)):
        out[at : at + n] = KINDS[p["kind"]](rng, n, p)
        at += n
    return out
