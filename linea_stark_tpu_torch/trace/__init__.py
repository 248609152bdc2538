"""Trace layer: loaders, synthetic workloads, the gadget builders."""

from .builders import build_lookup_columns, build_permutation_columns
from .loader import RawLookupTrace, RawPermutationTrace
from .raw_trace import BuiltTrace, build_trace
from .synthetic import gen_lookup_trace, gen_permutation_trace

__all__ = [
    "BuiltTrace",
    "RawLookupTrace",
    "RawPermutationTrace",
    "build_lookup_columns",
    "build_permutation_columns",
    "build_trace",
    "gen_lookup_trace",
    "gen_permutation_trace",
]
