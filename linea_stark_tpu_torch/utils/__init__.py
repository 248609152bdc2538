"""Utilities: CBOR codec, span-tree timing, native build helper."""
