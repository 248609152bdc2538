"""Hashing: Poseidon2 permutation, sponge, compression; native host engine."""
