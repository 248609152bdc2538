"""Synthetic workload generators (benchmark + test fixtures).

Reproduces the reference's benchmark workloads (README.md:11: random
permutation traces of shape columns×rows; SURVEY.md §7 "minimum end-to-end
slice": a random multiset and a shuffle of it).
"""

from __future__ import annotations

import numpy as np

from .loader import ONE_BYTES, RawLookupTrace, RawPermutationTrace


def _rand_col(rng: np.random.Generator, height: int) -> np.ndarray:
    # 31 random bytes + zero top byte keeps values < r without biasing tests
    col = rng.integers(0, 256, size=(height, 32), dtype=np.uint8)
    col[:, 0] = 0
    return col


def gen_permutation_trace(
    width: int, height: int, seed: int = 0, name: str = "synthetic-perm"
) -> RawPermutationTrace:
    """B's rows are a random shuffle of A's rows (a valid multiset equality)."""
    rng = np.random.default_rng(seed)
    a_cols = [_rand_col(rng, height) for _ in range(width)]
    perm = rng.permutation(height)
    b_cols = [c[perm] for c in a_cols]
    return RawPermutationTrace(a=a_cols, b=b_cols, name=name)


def gen_lookup_trace(
    a_width: int,
    height: int,
    num_b_tables: int = 1,
    seed: int = 0,
    name: str = "synthetic-lookup",
) -> RawLookupTrace:
    """Every A row appears among the B tables' rows (a valid lookup).

    B tables hold `height` distinct random rows; A rows are drawn (with
    repetition) from the union of B rows, so multiplicities exercise counts
    larger than one.
    """
    rng = np.random.default_rng(seed)
    b_tables = []
    all_rows = []
    for _ in range(num_b_tables):
        tbl = [_rand_col(rng, height) for _ in range(a_width)]
        b_tables.append(tbl)
        all_rows.extend(
            np.stack([c[i] for c in tbl]) for i in range(height)
        )
    picks = rng.integers(0, len(all_rows), size=height)
    a_cols = []
    for w in range(a_width):
        a_cols.append(np.stack([all_rows[p][w] for p in picks]))
    t = RawLookupTrace(a=a_cols, b=b_tables, name=name)
    t.default_filters()
    return t
