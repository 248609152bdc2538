"""NTT / low-degree-extension layer."""

from .ntt import coeffs_to_evals, coset_lde, evals_to_coeffs, intt, ntt, pad_coeffs, root_of_unity

__all__ = ["coeffs_to_evals", "coset_lde", "evals_to_coeffs", "intt", "ntt",
           "pad_coeffs", "root_of_unity"]
