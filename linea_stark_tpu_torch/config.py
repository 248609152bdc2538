"""Protocol configuration.

The reference fixes its protocol with compile-time type aliases and
hard-coded literals (bin/src/config.rs:9-25, bin/src/main.rs:58-64;
SURVEY.md §5.6).  Here the same decision points are runtime dataclasses:
hasher parameters, FRI knobs, coset shift — frozen and hashable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .field.constants import COSET_SHIFT
from .hash.poseidon2 import DEFAULT_PARAMS, Poseidon2Params


@dataclass(frozen=True)
class FriConfig:
    """Mirrors ``FriConfig`` at bin/src/main.rs:58-64 (defaults of record:
    log_blowup 3, final poly len 1, 33 queries, pow 0 shipped / 29 commented)."""

    log_blowup: int = 3
    log_final_poly_len: int = 0
    num_queries: int = 33
    proof_of_work_bits: int = 0

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup


@dataclass(frozen=True)
class StarkConfig:
    fri: FriConfig = field(default_factory=FriConfig)
    hash_params: Poseidon2Params = field(default_factory=lambda: DEFAULT_PARAMS)
    coset_shift: int = COSET_SHIFT
    # Merkle hasher sweep: "poseidon2" (default) or "keccak"
    # (bin/src/config.rs:11-18 swappable aliases; BASELINE.json configs).
    hasher: str = "poseidon2"
    # Enforce trace self-checks during build (reference asserts,
    # trace/src/permutation.rs:76-79, trace/src/lookup.rs:165-168).
    check_trace: bool = True
    # Transcript/proof-shape mode: "native" (this framework's order) or
    # "p3" (upstream p3-uni-stark/p3-fri order: bit-reversed FRI indexing,
    # commit-then-sample fold levels, blowup-count quotient chunks —
    # PARITY.md §3; exact byte equality with the fork additionally needs
    # captured Poseidon2 constants via ``hash_params``).
    transcript: str = "native"
    # Quotient chunk count: None = mode default (degree-aware for "native",
    # 2^log_blowup for "p3" — the reference commits 8 chunks,
    # bench.log:22-30); or an explicit power of two <= blowup.
    quotient_chunks: int = None

    def mmcs_hasher(self):
        """The Merkle hasher; the challenger stays Poseidon2 (``hash_params``)
        with either."""
        from .hash.hasher import KeccakHasher, Poseidon2Hasher

        if self.hasher == "keccak":
            return KeccakHasher()
        if self.hasher != "poseidon2":
            raise ValueError(f"unknown hasher {self.hasher!r}")
        return Poseidon2Hasher(self.hash_params)
