"""Uni-STARK prove/verify orchestration."""

from .proof import FriProof, Proof, QueryProof
from .uni_stark import VerificationError, compute_quotient, prove, verify

__all__ = ["FriProof", "Proof", "QueryProof", "VerificationError",
           "compute_quotient", "prove", "verify"]
