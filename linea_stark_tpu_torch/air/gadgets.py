"""AIR constraint gadgets: grand-product permutation and LogUp lookup.

Re-expresses the two constraint families of the reference's ``LineaAIR``
(air/src/lib.rs:57-114 lookup, :116-167 permutation) against the dual-backend
algebra.  Constraint enumeration order is part of the protocol (the prover
folds constraints with powers of a challenge in this exact order and the
verifier replays it), so both gadgets yield their constraints in the fixed
order documented below.

Column-index layouts are identical to the reference configs
(air/src/air_lookup.rs, air/src/air_permutation.rs) so traces are
interchangeable at the format level.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import Enum
from typing import Callable, Sequence


class Sel(Enum):
    """Row selector attached to each constraint."""

    EVERY = 0
    FIRST = 1
    TRANSITION = 2
    LAST = 3


@dataclass(frozen=True)
class PermutationAirConfig:
    """Column layout: [a_0..a_{w-1}, b_0..b_{w-1}, b_inverse, check]
    (air/src/air_permutation.rs:1-24)."""

    a_columns_ids: tuple
    b_columns_ids: tuple
    b_inverse_id: int
    check_id: int

    @property
    def width(self) -> int:
        return len(self.a_columns_ids) + len(self.b_columns_ids) + 2

    def shift(self, offset: int) -> "PermutationAirConfig":
        return PermutationAirConfig(
            tuple(i + offset for i in self.a_columns_ids),
            tuple(i + offset for i in self.b_columns_ids),
            self.b_inverse_id + offset,
            self.check_id + offset,
        )


@dataclass(frozen=True)
class LookupAirConfig:
    """Column layout (air/src/air_lookup.rs:1-40, trace/src/lookup.rs:178-214):
    [a cols, b tables' cols, a_filter, b_filters, a_inverses, b_inverses,
    occurrences, check]."""

    a_columns_ids: tuple
    b_columns_ids: tuple  # tuple of tuples, one per B table
    a_filter_id: int
    b_filter_id: tuple
    a_inverses_id: int
    b_inverses_id: tuple
    occurrences_id: tuple
    check_id: int

    @property
    def width(self) -> int:
        t = len(self.b_columns_ids)
        per_table = len(self.b_columns_ids[0])
        return len(self.a_columns_ids) + t * (per_table + 3) + 3

    def shift(self, offset: int) -> "LookupAirConfig":
        return LookupAirConfig(
            tuple(i + offset for i in self.a_columns_ids),
            tuple(tuple(i + offset for i in tbl) for tbl in self.b_columns_ids),
            self.a_filter_id + offset,
            tuple(i + offset for i in self.b_filter_id),
            self.a_inverses_id + offset,
            tuple(i + offset for i in self.b_inverses_id),
            tuple(i + offset for i in self.occurrences_id),
            self.check_id + offset,
        )


from .algebra import horner  # noqa: E402


def eval_permutation(cfg, local, nxt, alpha, delta, alg):
    """Constraints, in order (air/src/lib.rs:116-167):

    1. EVERY:      (b_comb + δ)·b_inv − 1                       (inverse ok)
    2. FIRST:      check − (a_comb + δ)·b_inv                   (init)
    3. TRANSITION: next_check − check·(a_next_comb + δ)·next_b_inv  (deg 3)
    4. LAST:       check − 1                                    (product is 1)
    """
    a_comb = horner(alg, alpha, [local(i) for i in cfg.a_columns_ids])
    b_comb = horner(alg, alpha, [local(i) for i in cfg.b_columns_ids])
    a_chal = alg.add(a_comb, delta)
    b_chal = alg.add(b_comb, delta)
    b_inv = local(cfg.b_inverse_id)
    check = local(cfg.check_id)

    yield Sel.EVERY, alg.sub(alg.mul(b_chal, b_inv), alg.one)
    yield Sel.FIRST, alg.sub(check, alg.mul(a_chal, b_inv))

    a_next_comb = horner(alg, alpha, [nxt(i) for i in cfg.a_columns_ids])
    a_next_chal = alg.add(a_next_comb, delta)
    yield Sel.TRANSITION, alg.sub(
        nxt(cfg.check_id), alg.mul(alg.mul(check, a_next_chal), nxt(cfg.b_inverse_id))
    )
    yield Sel.LAST, alg.sub(check, alg.one)


def eval_lookup(cfg, local, nxt, alpha, delta, alg):
    """Constraints, in order (air/src/lib.rs:57-114):

    1.   EVERY:      (a_comb + δ)·a_inv − 1
    2..: EVERY:      (b_comb_t + δ)·b_inv_t − 1        (one per B table)
    n+1. FIRST:      check − row_term(local)
    n+2. TRANSITION: (next_check − check) − row_term(next)
    n+3. LAST:       check − 0
    where row_term = filter_a·a_inv − Σ_t filter_b_t·occ_t·b_inv_t.
    """
    a_comb = horner(alg, alpha, [local(i) for i in cfg.a_columns_ids])
    a_chal = alg.add(a_comb, delta)
    yield Sel.EVERY, alg.sub(alg.mul(a_chal, local(cfg.a_inverses_id)), alg.one)

    local_term = alg.mul(local(cfg.a_filter_id), local(cfg.a_inverses_id))
    next_term = alg.mul(nxt(cfg.a_filter_id), nxt(cfg.a_inverses_id))

    every_b = []
    for t, cols in enumerate(cfg.b_columns_ids):
        b_comb = horner(alg, alpha, [local(i) for i in cols])
        b_chal = alg.add(b_comb, delta)
        every_b.append(
            alg.sub(alg.mul(b_chal, local(cfg.b_inverses_id[t])), alg.one)
        )
        local_term = alg.sub(
            local_term,
            alg.mul(
                alg.mul(local(cfg.b_filter_id[t]), local(cfg.occurrences_id[t])),
                local(cfg.b_inverses_id[t]),
            ),
        )
        next_term = alg.sub(
            next_term,
            alg.mul(
                alg.mul(nxt(cfg.b_filter_id[t]), nxt(cfg.occurrences_id[t])),
                nxt(cfg.b_inverses_id[t]),
            ),
        )
    for c in every_b:
        yield Sel.EVERY, c

    check = local(cfg.check_id)
    yield Sel.FIRST, alg.sub(check, local_term)
    yield Sel.TRANSITION, alg.sub(alg.sub(nxt(cfg.check_id), check), next_term)
    yield Sel.LAST, check  # check − 0


@dataclass(frozen=True)
class LineaAir:
    """Composition of gadget configs side by side (air/src/lib.rs:27-54).

    ``configs`` entries are PermutationAirConfig / LookupAirConfig whose
    column ids already point into the combined trace (the trace assembler
    applies the offsets, mirroring RawTrace::push_* + Config::shift).
    """

    configs: tuple

    @property
    def width(self) -> int:
        return sum(c.width for c in self.configs)

    def eval(self, local, nxt, alpha, delta, alg):
        """Yield (selector, constraint_value) over all gadgets, in order."""
        for cfg in self.configs:
            if isinstance(cfg, PermutationAirConfig):
                yield from eval_permutation(cfg, local, nxt, alpha, delta, alg)
            elif isinstance(cfg, LookupAirConfig):
                yield from eval_lookup(cfg, local, nxt, alpha, delta, alg)
            else:  # pragma: no cover
                raise TypeError(f"unknown AIR config {type(cfg)}")

    @property
    def max_constraint_degree(self) -> int:
        """Both gadgets' transition rows multiply three trace values
        (air/src/lib.rs:91-93, :156-161)."""
        return 3
