"""Fiat-Shamir transcript (hash challenger)."""

from .hash_challenger import HashChallenger

__all__ = ["HashChallenger"]
