"""The port's match finder at quality 2 (effort 5) against the eager
version it was factored from, the JAX package's jitted ``_match_find`` and
NumPy mirrors of its kernels: the shared tests of ``match_find_cases``."""

from __future__ import annotations

from match_find_cases import (  # noqa: F401  (the shared tests and their fixtures)
    _one_torch_thread,
    mf,
    test_bucket_mirror,
    test_distance_limit,
    test_f1_lane_differs_from_reference,
    test_match_find_composes_the_pieces,
    test_plain_pieces_equal_before,
    test_plain_pieces_equal_reference,
    test_select_mirror,
)

QUALITY = 2
