"""Polynomial commitment scheme layer: the two-adic FRI PCS behind
``commit_trace`` / ``commit_quotient`` / ``open`` / ``verify``."""

from .two_adic_fri import PcsData, TwoAdicFriPcs, VerificationError


def make_pcs(config) -> TwoAdicFriPcs:
    """Construct the PCS from a StarkConfig."""
    return TwoAdicFriPcs(
        fri=config.fri,
        hasher=config.mmcs_hasher(),
        shift=config.coset_shift,
        transcript=config.transcript,
        check_low_degree=config.check_trace,
    )


__all__ = ["PcsData", "TwoAdicFriPcs", "VerificationError", "make_pcs"]
