"""Proof container + serialization.

The reference never persists proofs (bin/src/main.rs:80-96 holds them in
memory; SURVEY.md §5.4).  We add CBOR serialization — needed for
cross-implementation verification and for multi-host provers to ship partial
results.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..merkle.mmcs import BatchOpening
from ..utils import cbor


@dataclass
class QueryProof:
    input_openings: list        # [BatchOpening lo, BatchOpening hi] per input tree:
                                # [[trace_lo, trace_hi], [quot_lo, quot_hi]]
    commit_openings: list       # BatchOpening per committed fold level


@dataclass
class CommitPhaseStep:
    """p3-fri's ``CommitPhaseProofStep { sibling_value, opening_proof }``:
    the fold partner at one commit-phase level plus its Merkle path (the
    query's own value is recomputed by the verifier)."""

    sibling_value: int
    path: list                  # sibling digests bottom-up


@dataclass
class P3QueryProof:
    """Query proof in p3 transcript mode: single-index input openings plus
    one CommitPhaseStep per committed fold level."""

    input_openings: list        # [BatchOpening per input tree]
    commit_steps: list          # [CommitPhaseStep]


@dataclass
class FriProof:
    commit_roots: list          # int, one per committed fold level
    final_poly: list            # int coefficients (2^log_final_poly_len)
    pow_witness: int
    query_proofs: list          # QueryProof, num_queries of them


@dataclass
class Proof:
    log_n: int
    width: int
    trace_root: int
    quotient_root: int
    trace_at_zeta: list         # int per trace column
    trace_at_zeta_next: list    # int per trace column
    quotient_chunks_at_zeta: list  # int per chunk
    fri: FriProof
    transcript: str = "native"  # "native" | "p3" (shape of query proofs)

    # -- serialization ------------------------------------------------------

    def to_bytes(self) -> bytes:
        def enc_opening(o: BatchOpening):
            return [o.index, [[v for v in row] for row in o.rows], list(o.siblings)]

        if self.transcript == "p3":
            qps = [
                [
                    [enc_opening(o) for o in q.input_openings],
                    [[s.sibling_value, list(s.path)] for s in q.commit_steps],
                ]
                for q in self.fri.query_proofs
            ]
        else:
            qps = [
                [
                    [[enc_opening(o) for o in pair] for pair in q.input_openings],
                    [enc_opening(o) for o in q.commit_openings],
                ]
                for q in self.fri.query_proofs
            ]
        d = {
            "transcript": self.transcript,
            "log_n": self.log_n,
            "width": self.width,
            "trace_root": self.trace_root,
            "quotient_root": self.quotient_root,
            "trace_at_zeta": self.trace_at_zeta,
            "trace_at_zeta_next": self.trace_at_zeta_next,
            "quotient_chunks_at_zeta": self.quotient_chunks_at_zeta,
            "fri": {
                "commit_roots": self.fri.commit_roots,
                "final_poly": self.fri.final_poly,
                "pow_witness": self.fri.pow_witness,
                "query_proofs": qps,
            },
        }
        return cbor.dumps(d)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proof":
        d = cbor.loads(data)

        def dec_opening(e):
            return BatchOpening(index=e[0], rows=e[1], siblings=e[2])

        fri = d["fri"]
        transcript = d.get("transcript", "native")
        if transcript == "p3":
            qps = [
                P3QueryProof(
                    input_openings=[dec_opening(o) for o in q[0]],
                    commit_steps=[
                        CommitPhaseStep(sibling_value=s[0], path=s[1])
                        for s in q[1]
                    ],
                )
                for q in fri["query_proofs"]
            ]
        else:
            qps = [
                QueryProof(
                    input_openings=[
                        [dec_opening(o) for o in pair] for pair in q[0]
                    ],
                    commit_openings=[dec_opening(o) for o in q[1]],
                )
                for q in fri["query_proofs"]
            ]
        return cls(
            log_n=d["log_n"],
            width=d["width"],
            trace_root=d["trace_root"],
            quotient_root=d["quotient_root"],
            trace_at_zeta=d["trace_at_zeta"],
            trace_at_zeta_next=d["trace_at_zeta_next"],
            quotient_chunks_at_zeta=d["quotient_chunks_at_zeta"],
            fri=FriProof(
                commit_roots=fri["commit_roots"],
                final_poly=fri["final_poly"],
                pow_witness=fri["pow_witness"],
                query_proofs=qps,
            ),
            transcript=transcript,
        )
