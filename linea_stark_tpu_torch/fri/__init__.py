"""FRI folding."""

from .fold import fold_codeword, fold_pair_int

__all__ = ["fold_codeword", "fold_pair_int"]
