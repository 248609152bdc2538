"""Host-side hash-sponge Fiat-Shamir challenger.

Equivalent of ``HashChallenger<Val, Hash, 1>`` (bin/src/config.rs:23,
bin/src/main.rs:78).  Transcripts are tiny and strictly serial, so this stays
on the host (SURVEY.md §2b: "transcripts are serial and tiny — not worth
device residency"); the only device interaction is the vectorized
proof-of-work grind, which searches candidate witnesses in parallel and
re-checks the winner here.

Semantics (documented because the fork source is not vendored; prover and
verifier both use exactly this object, so the protocol is self-consistent):

* ``observe(v)``  — clears any buffered output, appends v to the input buffer.
* ``sample()``    — if no buffered output: digest = hash(input_buffer) via the
  padding-free sponge, the input buffer is replaced by [digest] (chaining),
  and [digest] becomes the output buffer.  Pops one buffered element.
* ``sample_bits(b)`` — low b bits of a sample's canonical integer.
* ``grind(b)`` / ``check_witness(b, w)`` — proof-of-work: find/verify w such
  that observing w makes ``sample_bits(b) == 0``.
"""

from __future__ import annotations

from typing import Sequence

from ..field.constants import R_MOD
from ..hash import poseidon2 as p2


class HashChallenger:
    def __init__(
        self,
        initial: Sequence[int] = (),
        params: p2.Poseidon2Params = p2.DEFAULT_PARAMS,
    ):
        self.params = params
        self.input_buffer: list = [v % R_MOD for v in initial]
        self.output_buffer: list = []

    def clone(self) -> "HashChallenger":
        c = HashChallenger((), self.params)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def observe(self, value: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(value % R_MOD)

    def sample(self) -> int:
        if not self.output_buffer:
            digest = p2.hash_ints(self.input_buffer, self.params)
            self.input_buffer = [digest]
            self.output_buffer = [digest]
        return self.output_buffer.pop()

    def sample_bits(self, bits: int) -> int:
        assert 0 <= bits < R_MOD.bit_length()
        return self.sample() & ((1 << bits) - 1)

    # -- proof of work ------------------------------------------------------

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int, max_iters: int = 1 << 40) -> int:
        """Host fallback grind; the FRI prover uses the vectorized device
        search (fri/grind.py) and re-checks its winner through this object."""
        for w in range(max_iters):
            if self.clone().check_witness(bits, w):
                self.observe(w)
                assert self.sample_bits(bits) == 0
                return w
        raise RuntimeError("grind failed")
