"""The port's jax-free host modules agree with the JAX package's originals.

``linea_stark_tpu_torch`` cannot import ``linea_stark_tpu`` (its package
imports JAX, which the GPU machine lacks), so it carries copies of the host
modules the transcript and the verifier depend on.  Each copy is held here
to its original on the same inputs; none of these tests compiles anything.
"""

import random

import numpy as np
import pytest
import torch

from linea_stark_tpu.challenger import HashChallenger as RefChallenger
from linea_stark_tpu.field import constants as ref_constants
from linea_stark_tpu.field import oracle as ref_oracle
from linea_stark_tpu.hash import np_poseidon2 as ref_npp
from linea_stark_tpu.hash import poseidon2 as ref_p2
from linea_stark_tpu.prover.proof import Proof as RefProof
from linea_stark_tpu.trace import synthetic as ref_synthetic
from linea_stark_tpu.utils import cbor as ref_cbor
from linea_stark_tpu_torch.air import gadgets
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.field import constants, oracle
from linea_stark_tpu_torch.hash import keccak as kk
from linea_stark_tpu_torch.hash import native_engine as ne
from linea_stark_tpu_torch.hash import np_poseidon2 as npp
from linea_stark_tpu_torch.hash import poseidon2 as p2
from linea_stark_tpu_torch.kernels import poseidon2 as kp
from linea_stark_tpu_torch.prover.proof import Proof
from linea_stark_tpu_torch.trace import synthetic
from linea_stark_tpu_torch.utils import cbor

torch.set_num_threads(1)
R = constants.R_MOD
rng = random.Random(0x70C4)


@pytest.mark.parametrize("name", [
    "R_MOD", "MODULUS_BITS", "TWO_ADICITY", "MONT_R", "MONT_R2", "MONT_N0",
    "TWO_ADIC_GENERATOR", "COSET_SHIFT", "POSEIDON2_ALPHA",
])
def test_constants_match(name):
    assert getattr(constants, name) == getattr(ref_constants, name)


def test_oracle_matches():
    vals = [0, 1, R - 1] + [rng.randrange(R) for _ in range(20)]
    for a in vals:
        b = rng.randrange(1, R)
        assert oracle.mul(a, b) == ref_oracle.mul(a, b)
        assert oracle.add(a, b) == ref_oracle.add(a, b)
        assert oracle.sub(a, b) == ref_oracle.sub(a, b)
        assert oracle.inv(b) == ref_oracle.inv(b)
        assert oracle.to_mont(a) == ref_oracle.to_mont(a)
        assert oracle.mont_mul(a, b) == ref_oracle.mont_mul(a, b)


def test_poseidon2_constant_schedule_matches():
    assert p2.DEFAULT_PARAMS.constants == ref_p2.DEFAULT_PARAMS.constants
    assert p2.derive_round_constants() == ref_p2.derive_round_constants()
    assert (p2.DEFAULT_PARAMS.external_constants(1)
            == ref_p2.DEFAULT_PARAMS.external_constants(1))
    # the kernels' Montgomery (rounds, 3, 8) words are the reference's
    # (rounds, 3, 16) limb schedule repacked
    from linea_stark_tpu.kernels.pallas_poseidon2 import _params_const_array

    ref = _params_const_array(ref_p2.DEFAULT_PARAMS)  # (R, 3, 16) 16-bit limbs
    words = ref[..., 0::2] | (ref[..., 1::2] << np.uint32(16))
    np.testing.assert_array_equal(kp.constant_schedule(p2.DEFAULT_PARAMS), words)


def test_poseidon2_ints_match():
    for _ in range(5):
        s = [rng.randrange(R) for _ in range(3)]
        assert p2.permute_ints(s) == ref_p2.permute_ints(s)
    vals = [rng.randrange(R) for _ in range(7)]
    for k in range(8):
        assert p2.hash_ints(vals[:k]) == ref_p2.hash_ints(vals[:k])
    assert p2.compress_ints(vals[0], vals[1]) == ref_p2.compress_ints(vals[0], vals[1])


def test_keccak_oracle_matches():
    from linea_stark_tpu.hash import keccak as ref_kk

    assert kk._RC == ref_kk._RC and kk._ROT == ref_kk._ROT
    assert kk.RATE_BYTES == ref_kk.RATE_BYTES
    nprng = np.random.default_rng(0x4B)
    for length in [0, 1, 31, 32, 135, 136, 137, 200, 271, 272, 273, 300]:
        data = nprng.integers(0, 256, length, dtype=np.uint8).tobytes()
        assert kk.keccak256(data) == ref_kk.keccak256(data), length
    lanes = [rng.randrange(1 << 64) for _ in range(25)]
    assert kk.keccak_f_ints(lanes) == ref_kk.keccak_f_ints(lanes)
    vals = [rng.randrange(R) for _ in range(5)] + [0, R - 1]
    assert kk.keccak256_field(vals) == ref_kk.keccak256_field(vals)


def test_challenger_matches_over_random_transcript():
    ours, ref = HashChallenger(), RefChallenger()
    for step in range(200):
        op = rng.randrange(3)
        if op == 0:
            v = rng.randrange(R)
            ours.observe(v)
            ref.observe(v)
        elif op == 1:
            assert ours.sample() == ref.sample(), step
        else:
            bits = rng.randrange(0, 30)
            assert ours.sample_bits(bits) == ref.sample_bits(bits), step
    assert ours.check_witness(0, 0) == ref.check_witness(0, 0)


def test_cbor_bytes_match():
    obj = {"a": [1, 2, R - 1, 1 << 200], "b": b"\x00\x01", "t": "text",
           "n": -5, "nested": [[], {"k": [0]}]}
    assert cbor.dumps(obj) == ref_cbor.dumps(obj)
    assert cbor.loads(ref_cbor.dumps(obj)) == obj


def test_synthetic_trace_matches():
    ours = synthetic.gen_permutation_trace(3, 64, seed=7)
    ref = ref_synthetic.gen_permutation_trace(3, 64, seed=7)
    for x, y in zip(ours.a + ours.b, ref.a + ref.b):
        np.testing.assert_array_equal(x, y)


def test_native_engine_builds_from_port_constants_and_matches():
    a = [rng.randrange(R) for _ in range(9)]
    b = [rng.randrange(R) for _ in range(9)]
    ua, ub = ne.ints_to_u64(a), ne.ints_to_u64(b)
    assert ne.u64_to_ints(ne.mul(ua, ub)) == [oracle.mul(x, y) for x, y in zip(a, b)]
    assert ne.u64_to_ints(ne.compress(ua, ub, p2.DEFAULT_PARAMS)) == [
        ref_p2.compress_ints(x, y) for x, y in zip(a, b)
    ]
    with open(ne._HEADER) as f:
        header = f.read()
    assert f"{R & ((1 << 64) - 1):#x}" in header


def test_native_engine_passes_over_a_cc_that_cannot_link_openmp(monkeypatch, tmp_path):
    broken = tmp_path / "cc-without-openmp"
    broken.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' >&2\nexit 1\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CC", str(broken))
    assert ne.openmp_cc() in ("cc", "gcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(ne.BuildError, match="libgomp.spec"):
        ne.openmp_cc()


def test_np_poseidon2_matches():
    cols = [np.array([rng.randrange(R) for _ in range(6)], dtype=object) for _ in range(5)]
    np.testing.assert_array_equal(
        npp.hash_columns_vec(cols), ref_npp.hash_columns_vec(cols))
    f = np.array([rng.randrange(R) for _ in range(16)], dtype=object)
    np.testing.assert_array_equal(
        npp.fold_vec(f, 5, 22, 7), ref_npp.fold_vec(f, 5, 22, 7))


def test_gadget_config_matches():
    from linea_stark_tpu.air import gadgets as ref_gadgets

    cfg = gadgets.PermutationAirConfig((0, 1, 2), (3, 4, 5), 6, 7).shift(2)
    ref = ref_gadgets.PermutationAirConfig((0, 1, 2), (3, 4, 5), 6, 7).shift(2)
    assert (cfg.a_columns_ids, cfg.b_columns_ids, cfg.b_inverse_id, cfg.check_id) == (
        ref.a_columns_ids, ref.b_columns_ids, ref.b_inverse_id, ref.check_id)


def test_proof_codec_round_trips_reference_bytes():
    from linea_stark_tpu.merkle.mmcs import BatchOpening as RefOpening
    from linea_stark_tpu.prover.proof import FriProof, QueryProof

    op = RefOpening(3, [[1, 2, 3]], [4, 5])
    ref = RefProof(log_n=3, width=3, trace_root=9, quotient_root=8,
                   trace_at_zeta=[1, 2, 3], trace_at_zeta_next=[4, 5, 6],
                   quotient_chunks_at_zeta=[7, 8],
                   fri=FriProof([11], [12], 0, [QueryProof([[op, op], [op, op]], [op])]))
    data = ref.to_bytes()
    assert Proof.from_bytes(data).to_bytes() == data
