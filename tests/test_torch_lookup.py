"""The port's LogUp lookup workload vs the JAX reference on the CPU, exactly.

The sort-join multiplicities (``radix_argsort``, ``lookup_multiplicities``),
the lookup trace columns and ``build_trace`` with a lookup beside a
permutation, and whole proofs of ``bench.py``'s ``BENCH_WORKLOAD=lookup``
workload.  Two goldens anchor the bytes:

* ``tests/data/golden_lookup3_h16_b8.cbor``: the reference's proof of
  ``chip_smoke.bench_inputs(4, "poseidon2", "lookup")`` (a 3-column lookup
  into one 3-column table, 16 rows, blowup 8, 33 queries, no PoW, Poseidon2,
  native transcript);
* ``tests/data/golden_lookup3_h4096_b8.cbor``: the same at 2^12 rows, the
  configuration ``chip_smoke.py`` proves on the card.

Regenerating either from the reference, and proving the 2^12 one with the
port on the CPU, are ``slow``.
"""

import copy
import dataclasses
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from linea_stark_tpu.challenger import HashChallenger as RefChallenger
from linea_stark_tpu.config import FriConfig as RefFri
from linea_stark_tpu.config import StarkConfig as RefConfig
from linea_stark_tpu.field import fr as ref_fr
from linea_stark_tpu.prover import VerificationError as RefVerificationError
from linea_stark_tpu.prover import verify as ref_verify
from linea_stark_tpu.prover.proof import Proof as RefProof
from linea_stark_tpu.trace import builders as ref_builders
from linea_stark_tpu_torch.air.gadgets import LineaAir, LookupAirConfig
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.field import fr, oracle
from linea_stark_tpu_torch.field.constants import R_MOD
from linea_stark_tpu_torch.prover import VerificationError, prove, verify
from linea_stark_tpu_torch.prover.proof import Proof
from linea_stark_tpu_torch.trace import builders
from linea_stark_tpu_torch.trace.loader import RawLookupTrace
from linea_stark_tpu_torch.trace.raw_trace import build_trace
from linea_stark_tpu_torch.trace.synthetic import gen_lookup_trace, gen_permutation_trace

torch.set_num_threads(1)
GOLDEN_H16 = os.path.join(chip_smoke.HERE, "tests", "data", "golden_lookup3_h16_b8.cbor")
AIR = LineaAir((LookupAirConfig((0, 1, 2), ((3, 4, 5),), 6, (7,), 8, (9,), (10,), 11),))
REF_CFG = RefConfig(fri=RefFri(log_blowup=3, log_final_poly_len=0, num_queries=33,
                               proof_of_work_bits=0))
ZERO = np.zeros(32, np.uint8)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _ref_air():
    from linea_stark_tpu.air.gadgets import LineaAir as RefAir
    from linea_stark_tpu.air.gadgets import LookupAirConfig as RefLookup

    return RefAir((RefLookup((0, 1, 2), ((3, 4, 5),), 6, (7,), 8, (9,), (10,), 11),))


def _ref_planes(vals):
    return jnp.asarray(ref_fr.pack_ints(vals))


def _ref_planes_raw(vals):
    return jnp.asarray(ref_fr.pack_ints(vals, mont=False))


def _seq_multiplicities(a, a_f, b, b_f) -> list:
    """The reference's sequential rule: count the filtered A values, then the
    first filtered B position holding a value takes (and consumes) its count."""
    counts = {}
    for v, f in zip(a, a_f):
        if f:
            counts[v] = counts.get(v, 0) + 1
    return [counts.pop(v, 0) if f else 0 for v, f in zip(b, b_f)]


def test_radix_argsort_matches_reference():
    """Keys with words at and above 2^31 (negative as int32) and repeats."""
    r = random.Random(3)
    pool = [0, 1, R_MOD - 1, (1 << 252) + (1 << 31), (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    keys = [r.choice(pool) if r.random() < 0.5 else r.randrange(R_MOD) for _ in range(60)]
    perm = builders.radix_argsort(fr.pack_ints(keys, mont=False))
    want = np.asarray(ref_builders.radix_argsort(_ref_planes_raw(keys)))
    np.testing.assert_array_equal(perm.numpy(), want)
    assert perm.tolist() == sorted(range(len(keys)), key=lambda i: keys[i])


def test_lookup_multiplicities_match_reference():
    """Repeated A values, filtered-out A rows, values in several B
    positions, and a value whose first B position is filtered out (its
    count moves on to the next)."""
    r = random.Random(11)
    pool = [r.randrange(R_MOD) for _ in range(5)] + [0, R_MOD - 1]
    n, t = 8, 2
    a = [r.choice(pool) for _ in range(n)]
    b = [r.choice(pool) for _ in range(n * t)]
    a_f = [r.random() < 0.8 for _ in range(n)]
    b_f = [r.random() < 0.7 for _ in range(n * t)]
    a[0] = a[5] = r.randrange(R_MOD)  # a value of its own, in two A rows
    a_f[0] = a_f[5] = True
    b[3], b_f[3], b[9], b_f[9], b[14], b_f[14] = a[0], False, a[0], True, a[0], True
    got = builders.lookup_multiplicities(fr.pack_ints(a), torch.tensor(a_f),
                                         fr.pack_ints(b), torch.tensor(b_f))
    want = np.asarray(ref_builders.lookup_multiplicities(
        _ref_planes(a), jnp.asarray(a_f), _ref_planes(b), jnp.asarray(b_f)))
    assert got.tolist() == want.tolist() == _seq_multiplicities(a, a_f, b, b_f)
    assert (got[3], got[9], got[14]) == (0, 2, 0)


def _lookup_raw() -> RawLookupTrace:
    """8 rows, 2 B tables of width 2: a repeated A row, zero filters on
    both sides, and a row held by both tables."""
    raw = gen_lookup_trace(2, 8, num_b_tables=2, seed=5)
    a, (b0, b1) = raw.a, raw.b
    for col, src0, src1 in zip(a, b0, b1):
        col[7] = col[0]
        src1[2] = src0[2]
        src1[1] = col[3]
    raw.a_filter[4] = ZERO
    raw.b_filter[1][1] = ZERO
    raw.b_filter[0][6] = ZERO
    return raw


def test_build_trace_lookup_and_permutation_match_reference():
    """Columns, configs and multiplicities of a lookup beside a permutation
    (lookups first), against the reference's build_trace."""
    from linea_stark_tpu.trace import build_trace as ref_build_trace

    alpha, delta = 0x5DEECE66D % R_MOD, 0xB1E32C5 % R_MOD
    lk, pm = _lookup_raw(), gen_permutation_trace(2, 8, seed=6)
    ref = ref_build_trace([pm], [lk], alpha, delta, check=False)
    built = build_trace([pm], [lk], alpha, delta, check=False, device="cpu")
    assert torch.equal(built.matrix, fr.from_ref_planes(np.asarray(ref.matrix)))
    assert [dataclasses.astuple(c) for c in built.air.configs] == [
        dataclasses.astuple(c) for c in ref.air.configs]
    assert [type(c).__name__ for c in built.air.configs] == [
        "LookupAirConfig", "PermutationAirConfig"]
    lookup, perm = built.air.configs
    assert (lookup.occurrences_id, lookup.check_id, lookup.width) == ((12, 13), 14, 15)
    assert (perm.a_columns_ids, perm.check_id) == ((15, 16), 20)
    assert built.matrix.shape == (8, 21, 8)


def test_build_trace_self_check():
    """A valid lookup's check column ends at 0; a broken one is refused."""
    raw = gen_lookup_trace(3, 8, num_b_tables=1, seed=9)
    alpha, delta = 12345, 67890
    built = build_trace([], [raw], alpha, delta, device="cpu")
    assert fr.unpack_ints(built.matrix[:, built.air.configs[0].check_id, -1:]) == [0]
    raw.a[0][2, 31] ^= 1  # an A row no table holds
    with pytest.raises(AssertionError, match="should be 0"):
        build_trace([], [raw], alpha, delta, device="cpu")


def _port_proof(log_h):
    config, raw, alpha, delta = chip_smoke.bench_inputs(log_h, "poseidon2", "lookup")
    built = chip_smoke.build_bench_trace(raw, alpha, delta, "cpu")
    assert dataclasses.astuple(built.air.configs[0]) == dataclasses.astuple(AIR.configs[0])
    return config, alpha, delta, prove(config, built.air, built.matrix, [alpha, delta],
                                       HashChallenger())


def test_h16_proof_bytes_equal_reference_golden_and_cross_verify():
    config, alpha, delta, proof = _port_proof(4)
    data = proof.to_bytes()
    assert data == _read(GOLDEN_H16)
    ref_verify(REF_CFG, _ref_air(), RefProof.from_bytes(data), [alpha, delta],
               RefChallenger())
    verify(config, AIR, Proof.from_bytes(data), [alpha, delta], HashChallenger())
    bad = copy.deepcopy(proof)
    bad.trace_at_zeta[0] = oracle.add(bad.trace_at_zeta[0], 1)
    with pytest.raises(VerificationError):
        verify(config, AIR, bad, [alpha, delta], HashChallenger())
    with pytest.raises(RefVerificationError):
        ref_verify(REF_CFG, _ref_air(), RefProof.from_bytes(bad.to_bytes()),
                   [alpha, delta], RefChallenger())


def test_h4096_golden_verifies_with_both_verifiers():
    config, _raw, alpha, delta = chip_smoke.bench_inputs(12, "poseidon2", "lookup")
    data = _read(chip_smoke.GOLDEN_LOOKUP)
    proof = Proof.from_bytes(data)
    assert proof.log_n == 12 and proof.width == 12 and proof.to_bytes() == data
    verify(config, AIR, proof, [alpha, delta], HashChallenger())
    ref_verify(REF_CFG, _ref_air(), RefProof.from_bytes(data), [alpha, delta],
               RefChallenger())


def _ref_proof_bytes(log_h) -> bytes:
    from linea_stark_tpu.prover import prove as ref_prove
    from linea_stark_tpu.trace import build_trace as ref_build_trace

    _config, raw, alpha, delta = chip_smoke.bench_inputs(log_h, "poseidon2", "lookup")
    built = ref_build_trace([], [raw], alpha, delta, check=False)
    return ref_prove(REF_CFG, built.air, built.matrix, [alpha, delta],
                     RefChallenger()).to_bytes()


@pytest.mark.slow  # ~2.5 min of XLA-CPU compile and run
def test_reference_regenerates_h16_golden():
    assert _ref_proof_bytes(4) == _read(GOLDEN_H16)


@pytest.mark.slow  # minutes of XLA-CPU compile and run
def test_reference_regenerates_h4096_golden():
    assert _ref_proof_bytes(12) == _read(chip_smoke.GOLDEN_LOOKUP)


@pytest.mark.slow  # minutes of plain int64 Poseidon2 on the CPU
def test_port_cpu_reproduces_h4096_golden():
    assert _port_proof(12)[3].to_bytes() == _read(chip_smoke.GOLDEN_LOOKUP)
