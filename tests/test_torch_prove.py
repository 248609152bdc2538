"""The port's prove path vs the JAX reference on the CPU.

Same synthetic trace and challenges on both sides, the main path's FRI
settings (blowup 8, no PoW; a small query count): the built trace and the
quotient must be equal, the proof bytes (``Proof.to_bytes()``) identical,
each side's verifier must accept the other's proof, and a tampered proof
must be rejected.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linea_stark_tpu.challenger import HashChallenger as RefChallenger
from linea_stark_tpu.config import FriConfig as RefFri
from linea_stark_tpu.config import StarkConfig as RefConfig
from linea_stark_tpu.ntt import coset_lde as ref_coset_lde
from linea_stark_tpu.prover import compute_quotient as ref_compute_quotient
from linea_stark_tpu.prover import prove as ref_prove
from linea_stark_tpu.prover import verify as ref_verify
from linea_stark_tpu.prover.proof import Proof as RefProof
from linea_stark_tpu.trace import build_trace as ref_build_trace
from linea_stark_tpu.trace import gen_permutation_trace
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.config import FriConfig, StarkConfig
from linea_stark_tpu_torch.field import fr, oracle
from linea_stark_tpu_torch.field.constants import COSET_SHIFT, R_MOD
from linea_stark_tpu_torch.ntt.ntt import coset_lde
from linea_stark_tpu_torch.prover import VerificationError, compute_quotient, prove, verify
from linea_stark_tpu_torch.prover.proof import Proof
from linea_stark_tpu_torch.trace.raw_trace import build_trace

torch.set_num_threads(1)
ALPHA = 0x5DEECE66D % R_MOD
DELTA = 0xB1E32C5 % R_MOD
QUERIES = 4
REF_CFG = RefConfig(fri=RefFri(log_blowup=3, num_queries=QUERIES, proof_of_work_bits=0))
CFG = StarkConfig(fri=FriConfig(log_blowup=3, num_queries=QUERIES, proof_of_work_bits=0))


def _port_proof(raw):
    built = build_trace([raw], [], ALPHA, DELTA, device="cpu")
    return built, prove(CFG, built.air, built.matrix, [ALPHA, DELTA], HashChallenger())


@pytest.mark.parametrize("height", [8, 16])
def test_proof_bytes_equal_reference_and_cross_verify(height):
    raw = gen_permutation_trace(3, height, seed=height)
    ref_built = ref_build_trace([raw], [], ALPHA, DELTA)
    ref_bytes = ref_prove(REF_CFG, ref_built.air, ref_built.matrix, [ALPHA, DELTA],
                          RefChallenger()).to_bytes()
    built, proof = _port_proof(raw)
    assert torch.equal(built.matrix, fr.from_ref_planes(np.asarray(ref_built.matrix)))
    assert proof.to_bytes() == ref_bytes
    # each verifier accepts the other side's proof
    ref_verify(REF_CFG, ref_built.air, RefProof.from_bytes(proof.to_bytes()),
               [ALPHA, DELTA], RefChallenger())
    verify(CFG, built.air, Proof.from_bytes(ref_bytes), [ALPHA, DELTA], HashChallenger())


def test_trace_and_quotient_match_reference():
    n = 8
    raw = gen_permutation_trace(3, n, seed=3)
    ref_built = ref_build_trace([raw], [], ALPHA, DELTA)
    built = build_trace([raw], [], ALPHA, DELTA, device="cpu")
    assert torch.equal(built.matrix, fr.from_ref_planes(np.asarray(ref_built.matrix)))
    gamma = 0x1234567 % R_MOD
    ref_lde = ref_coset_lde(ref_built.matrix, 3, COSET_SHIFT)
    lde = coset_lde(built.matrix, 3, COSET_SHIFT)
    assert torch.equal(lde, fr.from_ref_planes(np.asarray(ref_lde)))
    want = ref_compute_quotient(ref_lde, ref_built.air, ALPHA, DELTA, gamma, n,
                                COSET_SHIFT, n_chunks=2)
    got = compute_quotient(lde, built.air, ALPHA, DELTA, gamma, n, COSET_SHIFT, n_chunks=2)
    assert tuple(got.shape) == (8, 2, n)
    assert torch.equal(got, fr.from_ref_planes(np.asarray(want)))


@pytest.fixture(scope="module")
def port_proof_h8():
    raw = gen_permutation_trace(3, 8, seed=11)
    return _port_proof(raw)


def _tamper_opened(p):
    p.trace_at_zeta[1] = oracle.add(p.trace_at_zeta[1], 1)


def _tamper_root(p):
    p.fri.commit_roots[0] = oracle.add(p.fri.commit_roots[0], 1)


def _tamper_row(p):
    op = p.fri.query_proofs[0].input_openings[0][0]
    op.rows[0][0] = oracle.add(op.rows[0][0], 1)


def _tamper_final(p):
    p.fri.final_poly[0] = oracle.add(p.fri.final_poly[0], 1)


def _tamper_quotient(p):
    p.quotient_chunks_at_zeta[0] = oracle.add(p.quotient_chunks_at_zeta[0], 1)


@pytest.mark.parametrize("tamper", [_tamper_opened, _tamper_root, _tamper_row,
                                    _tamper_final, _tamper_quotient])
def test_tampered_proof_rejected(port_proof_h8, tamper):
    built, proof = port_proof_h8
    verify(CFG, built.air, proof, [ALPHA, DELTA], HashChallenger())
    bad = copy.deepcopy(proof)
    tamper(bad)
    with pytest.raises(VerificationError):
        verify(CFG, built.air, bad, [ALPHA, DELTA], HashChallenger())


def test_build_trace_runs_on_the_card_unless_asked_for_the_cpu():
    raw = gen_permutation_trace(3, 8, seed=11)
    if torch.cuda.is_available():
        assert build_trace([raw], [], ALPHA, DELTA).matrix.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trace([raw], [], ALPHA, DELTA)


def test_prove_device_argument(port_proof_h8):
    built, proof = port_proof_h8
    again = prove(CFG, built.air, built.matrix, [ALPHA, DELTA], HashChallenger(),
                  device=torch.device("cpu"))
    assert again.to_bytes() == proof.to_bytes()
