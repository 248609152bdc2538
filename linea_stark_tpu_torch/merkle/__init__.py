"""Merkle MMCS."""
