"""Uni-STARK prove/verify over the two-adic FRI PCS; port of
``linea_stark_tpu/prover/uni_stark.py`` (native transcript).

Transcript order (challenger fresh per prove/verify):

    observe(log_n); observe(width); observe(trace_root)
    observe(alpha); observe(delta)                  # public values
    gamma   = sample()                              # constraint folding
    observe(quotient_root)
    zeta    = sample()                              # out-of-domain point
    observe(trace@zeta ..W); observe(trace@zeta·g ..W); observe(chunks@zeta)
    alpha_p = sample()                              # opening reduction
    for each fold round: beta = sample(); [commit folded; observe root]
    observe(final_poly coefficients); pow witness; query indices

The quotient is evaluated on the first C cosets of the LDE domain; chunk i
holds the values at LDE indices = i mod blowup, a polynomial of degree < n
on coset shift·ω^i.  The verifier recomposes
q(ζ) = sum_i q_i(ζ)·prod_{j≠i}(ζ^n − c_j^n)/(c_i^n − c_j^n).
"""

from __future__ import annotations

import torch

from .. import fr_ops as fo
from ..air.algebra import ScalarAlgebra, VectorAlgebra
from ..air.gadgets import LineaAir, Sel
from ..challenger import HashChallenger
from ..config import StarkConfig
from ..field import fr, oracle
from ..field.constants import R_MOD
from ..ntt.ntt import root_of_unity
from ..pcs import make_pcs
from ..pcs.two_adic_fri import VerificationError, _fused
from ..utils.timing import span
from .proof import Proof

__all__ = ["VerificationError", "compute_quotient", "prove", "verify"]


def _selector_factors(sel: Sel, zeta: int, n: int, z_h: int, omega_n: int) -> int:
    """Scalar Z-compensated selector factors at ζ."""
    last = pow(omega_n, n - 1, R_MOD)
    if sel == Sel.EVERY:
        return 1
    if sel == Sel.FIRST:
        return oracle.mul(z_h, oracle.inv(oracle.sub(zeta, 1)))
    if sel == Sel.LAST:
        return oracle.mul(z_h, oracle.inv(oracle.sub(zeta, last)))
    return oracle.sub(zeta, last)  # TRANSITION


def num_quotient_chunks(air: LineaAir) -> int:
    """Degree-aware chunk count: the quotient has degree < (max_deg−1)·n, so
    (max_deg−1) rounded up to a power of two cosets determine it."""
    deg = max(air.max_constraint_degree, 2)
    c = 1
    while c < deg - 1:
        c *= 2
    return c


def quotient_chunk_count(config: StarkConfig, air: LineaAir) -> int:
    """Explicit override, else the degree-aware count."""
    if config.quotient_chunks is not None:
        c = config.quotient_chunks
        assert c & (c - 1) == 0 and c <= config.fri.blowup
        return c
    return num_quotient_chunks(air)


def compute_quotient(trace_lde: torch.Tensor, air: LineaAir, alpha: int,
                     delta: int, gamma: int, n: int, shift: int,
                     n_chunks: int = None) -> torch.Tensor:
    """Vectorized constraint evaluation -> quotient evals, coset-major.

    Input ``trace_lde``: (8, W, n_lde) evals on shift·H_lde.  Output:
    (8, n_chunks, n), slice i holding the quotient's values on coset
    shift·ω_lde^i·H_n.  ``next`` rows are a roll by one along each coset's
    n-point axis; constraints fold with γ^k in enumeration order, grouped
    by selector so each selector factor multiplies one accumulated vector."""
    n_lde = trace_lde.shape[-1]
    blowup = n_lde // n
    if n_chunks is None:
        n_chunks = num_quotient_chunks(air)
    assert n_chunks <= blowup
    c = n_chunks
    dev = trace_lde.device
    log_lde = n_lde.bit_length() - 1
    omega_lde = root_of_unity(log_lde)
    omega_n = root_of_unity(n.bit_length() - 1)

    sub = torch.stack([trace_lde[..., i::blowup] for i in range(c)], dim=2)  # (8, W, C, n)
    alg = VectorAlgebra((c, n), dev)
    alpha_d = fr.full((c, n), alpha, device=dev)
    delta_d = fr.full((c, n), delta, device=dev)

    def local(i):
        return sub[:, i]

    def nxt(i):
        return torch.roll(sub[:, i], -1, dims=-1)

    acc = {s: None for s in Sel}
    gk = 1
    for sel, val in air.eval(local, nxt, alpha_d, delta_d, alg):
        term = fo.mul_const(val, gk)
        acc[sel] = term if acc[sel] is None else fo.add(acc[sel], term)
        gk = oracle.mul(gk, gamma)

    # Domain: x[i, t] = shift·ω_lde^i·ω_n^t (coset i, position t).
    coset_shifts = fo.mul_const(fo.powers(omega_lde, c, dev), shift)
    x_vec = fo.mul(coset_shifts[:, :, None], fo.powers(omega_n, n, dev)[:, None, :])
    # Z_H(x) = x^n − 1 is constant on each coset.
    s_n = pow(shift, n, R_MOD)
    omega_b = pow(omega_lde, n, R_MOD)  # order `blowup`
    inv_z = fr.pack_ints(
        [oracle.inv(oracle.sub(oracle.mul(s_n, pow(omega_b, i, R_MOD)), 1)) for i in range(c)],
        device=dev,
    )[:, :, None]  # (8, C, 1)
    last = pow(omega_n, n - 1, R_MOD)
    x_minus_last = fo.sub(x_vec, fr.const(last, device=dev))
    # one inversion for both selector denominators
    inverse = fo.batch_inverse if _fused() else fo.batch_inverse_eager
    sel_inv = inverse(
        torch.cat([fo.sub(x_vec, fr.const(1, device=dev)), x_minus_last], dim=-1)
    )
    x_minus_1_inv = sel_inv[..., :n]
    x_minus_last_inv = sel_inv[..., n:]

    terms = []
    if acc[Sel.EVERY] is not None:
        terms.append(fo.mul(acc[Sel.EVERY], inv_z))
    if acc[Sel.FIRST] is not None:
        terms.append(fo.mul(acc[Sel.FIRST], x_minus_1_inv))
    if acc[Sel.LAST] is not None:
        terms.append(fo.mul(acc[Sel.LAST], x_minus_last_inv))
    if acc[Sel.TRANSITION] is not None:
        t = fo.mul(acc[Sel.TRANSITION], x_minus_last)
        terms.append(fo.mul(t, inv_z))
    q = fr.zeros((c, n), device=dev)
    for t in terms:
        q = fo.add(q, t)
    return q


def prove(config: StarkConfig, air: LineaAir, trace: torch.Tensor,
          public_values: list, challenger: HashChallenger, device=None) -> Proof:
    """trace: (8, W, n) Montgomery words; public_values = [alpha, delta].
    The work runs on ``device`` (default: the trace's device)."""
    alpha, delta = public_values
    if device is not None:
        trace = trace.to(device)
    pcs = make_pcs(config)

    w = trace.shape[1]
    n = trace.shape[-1]
    log_n = n.bit_length() - 1
    omega_n = root_of_unity(log_n)

    with span("commit trace", dims=f"{w}x{n}", added_bits=config.fri.log_blowup):
        trace_root, trace_data = pcs.commit_trace(trace)

    challenger.observe(log_n)
    challenger.observe(w)
    challenger.observe(trace_root)
    challenger.observe(alpha)
    challenger.observe(delta)
    gamma = challenger.sample()

    n_chunks = quotient_chunk_count(config, air)
    with span("compute quotient polynomial", dims=f"{n_chunks}x{n}"):
        chunks = compute_quotient(
            trace_data.lde, air, alpha, delta, gamma, n, config.coset_shift,
            n_chunks=n_chunks,
        )

    with span("commit quotient chunks"):
        quotient_root, quot_data = pcs.commit_quotient(chunks)
        del chunks

    challenger.observe(quotient_root)
    zeta = challenger.sample()
    zeta_next = oracle.mul(zeta, omega_n)

    trace_at_zeta, trace_at_zeta_next, chunks_at_zeta, fri_proof = pcs.open(
        trace_data, quot_data, zeta, zeta_next, challenger
    )

    return Proof(
        log_n=log_n,
        width=w,
        trace_root=trace_root,
        quotient_root=quotient_root,
        trace_at_zeta=trace_at_zeta,
        trace_at_zeta_next=trace_at_zeta_next,
        quotient_chunks_at_zeta=chunks_at_zeta,
        fri=fri_proof,
        transcript=config.transcript,
    )


def verify(config: StarkConfig, air: LineaAir, proof: Proof,
           public_values: list, challenger: HashChallenger) -> None:
    """Raises VerificationError on any failed check (scalar, host-side)."""
    alpha, delta = public_values
    pcs = make_pcs(config)
    if proof.transcript != config.transcript:
        raise VerificationError("proof transcript mode mismatch")
    shift = config.coset_shift

    n = 1 << proof.log_n
    w = proof.width
    if w != air.width:
        raise VerificationError("width mismatch with AIR")
    log_lde = proof.log_n + config.fri.log_blowup
    n_lde = 1 << log_lde
    omega_lde = root_of_unity(log_lde)
    omega_n = root_of_unity(proof.log_n)

    challenger.observe(proof.log_n)
    challenger.observe(w)
    challenger.observe(proof.trace_root)
    challenger.observe(alpha)
    challenger.observe(delta)
    gamma = challenger.sample()
    challenger.observe(proof.quotient_root)
    zeta = challenger.sample()
    zeta_next = oracle.mul(zeta, omega_n)

    n_chunks = quotient_chunk_count(config, air)
    if len(proof.quotient_chunks_at_zeta) != n_chunks:
        raise VerificationError("wrong number of quotient chunks")
    if len(proof.trace_at_zeta) != w or len(proof.trace_at_zeta_next) != w:
        raise VerificationError("wrong number of opened trace values")

    pcs.verify(
        proof.trace_root,
        proof.quotient_root,
        ((n_lde, w), (n_lde, n_chunks)),
        (proof.trace_at_zeta, proof.trace_at_zeta_next, proof.quotient_chunks_at_zeta),
        zeta,
        zeta_next,
        proof.fri,
        challenger,
    )

    # quotient identity at ζ (AIR re-evaluation)
    alg = ScalarAlgebra()
    z_h = oracle.sub(pow(zeta, n, R_MOD), 1)
    if z_h == 0:
        raise VerificationError("zeta in trace domain")
    folded = 0
    gk = 1
    for sel, val in air.eval(lambda i: proof.trace_at_zeta[i],
                             lambda i: proof.trace_at_zeta_next[i], alpha, delta, alg):
        sf = _selector_factors(sel, zeta, n, z_h, omega_n)
        folded = oracle.add(folded, oracle.mul(oracle.mul(gk, sf), val))
        gk = oracle.mul(gk, gamma)

    s_n = pow(shift, n, R_MOD)
    omega_b = pow(omega_lde, n, R_MOD)
    c_n = [oracle.mul(s_n, pow(omega_b, i, R_MOD)) for i in range(n_chunks)]
    zeta_n = pow(zeta, n, R_MOD)
    q_zeta = 0
    for i in range(n_chunks):
        li = 1
        for j in range(n_chunks):
            if j != i:
                li = oracle.mul(li, oracle.mul(oracle.sub(zeta_n, c_n[j]),
                                               oracle.inv(oracle.sub(c_n[i], c_n[j]))))
        q_zeta = oracle.add(q_zeta, oracle.mul(proof.quotient_chunks_at_zeta[i], li))
    if folded != oracle.mul(z_h, q_zeta):
        raise VerificationError("quotient identity failed at zeta")
