"""The golden proof the GPU smoke run is held to.

``tests/data/golden_perm3x3_h4096_b8.cbor`` is the reference's proof of the
bench configuration at 2^12 rows: 3x3 permutation AIR, trace seed 7, the
challenges of ``random.Random(0xBE7C4)``, blowup 8, 33 queries, no PoW,
Poseidon2, native transcript.  Its LDE has 2^15 points, so the first FRI
round runs on the device before the host tail.  ``chip_smoke.py`` proves
the same configuration on the card and requires these bytes.
"""

import pytest
import torch

import chip_smoke
from linea_stark_tpu_torch.air.gadgets import LineaAir, PermutationAirConfig
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.prover import prove, verify
from linea_stark_tpu_torch.prover.proof import Proof
from linea_stark_tpu_torch.trace.raw_trace import build_trace

torch.set_num_threads(1)
AIR = LineaAir((PermutationAirConfig((0, 1, 2), (3, 4, 5), 6, 7),))


def _golden() -> bytes:
    with open(chip_smoke.GOLDEN, "rb") as f:
        return f.read()


def test_golden_verifies_with_both_verifiers():
    from linea_stark_tpu.challenger import HashChallenger as RefChallenger
    from linea_stark_tpu.config import FriConfig as RefFri
    from linea_stark_tpu.config import StarkConfig as RefConfig
    from linea_stark_tpu.prover import verify as ref_verify
    from linea_stark_tpu.prover.proof import Proof as RefProof
    from linea_stark_tpu.air.gadgets import LineaAir as RefAir
    from linea_stark_tpu.air.gadgets import PermutationAirConfig as RefPerm

    config, _raw, alpha, delta = chip_smoke.bench_inputs(12)
    proof = Proof.from_bytes(_golden())
    assert proof.log_n == 12 and proof.to_bytes() == _golden()
    verify(config, AIR, proof, [alpha, delta], HashChallenger())
    ref_cfg = RefConfig(fri=RefFri(log_blowup=3, log_final_poly_len=0,
                                   num_queries=33, proof_of_work_bits=0))
    ref_air = RefAir((RefPerm((0, 1, 2), (3, 4, 5), 6, 7),))
    ref_verify(ref_cfg, ref_air, RefProof.from_bytes(_golden()), [alpha, delta],
               RefChallenger())


@pytest.mark.slow  # ~4 min of XLA-CPU compile and run
def test_reference_regenerates_golden():
    from linea_stark_tpu.challenger import HashChallenger as RefChallenger
    from linea_stark_tpu.config import FriConfig as RefFri
    from linea_stark_tpu.config import StarkConfig as RefConfig
    from linea_stark_tpu.prover import prove as ref_prove
    from linea_stark_tpu.trace import build_trace as ref_build_trace

    _config, raw, alpha, delta = chip_smoke.bench_inputs(12)
    cfg = RefConfig(fri=RefFri(log_blowup=3, log_final_poly_len=0, num_queries=33,
                               proof_of_work_bits=0))
    built = ref_build_trace([raw], [], alpha, delta, check=False)
    proof = ref_prove(cfg, built.air, built.matrix, [alpha, delta], RefChallenger())
    assert proof.to_bytes() == _golden()


@pytest.mark.slow  # minutes of plain int64 Poseidon2 on the CPU
def test_port_cpu_reproduces_golden():
    config, raw, alpha, delta = chip_smoke.bench_inputs(12)
    built = build_trace([raw], [], alpha, delta, check=False, device="cpu")
    proof = prove(config, built.air, built.matrix, [alpha, delta], HashChallenger())
    assert proof.to_bytes() == _golden()
