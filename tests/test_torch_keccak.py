"""The port's Keccak MMCS path vs the JAX reference on the CPU, exactly.

The plain Keccak-256, the field-digest hasher, the MMCS commit and batch
verify, the native engine's Keccak sweeps and whole proofs of the
``BENCH_HASHER=keccak`` workload.  Two goldens anchor the bytes:

* ``tests/data/golden_perm3x3_h16_b8_keccak.cbor``: the reference's proof of
  ``chip_smoke.bench_inputs(4, "keccak")`` (16 rows, blowup 8, 33 queries,
  no PoW, native transcript, Keccak MMCS);
* ``tests/data/golden_perm3x3_h4096_b8_keccak.cbor``: the same at 2^12 rows,
  the configuration ``chip_smoke.py`` proves on the card.

Both are the reference's bytes, and the port reproduces both on the CPU
(the 2^12 one also on the card, ``chip_smoke.py``).  Regenerating either
from the reference, and proving the 2^12 one with the port on the CPU, are
``slow``.
"""

import copy
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
from linea_stark_tpu.hash import native_engine as ref_ne
from linea_stark_tpu.hash.hasher import KeccakHasher as RefKeccakHasher
from linea_stark_tpu.hash.keccak import keccak256_fixed_vec as ref_fixed_vec
from linea_stark_tpu.prover import VerificationError as RefVerificationError
from linea_stark_tpu.prover import verify as ref_verify
from linea_stark_tpu.prover.proof import Proof as RefProof
from linea_stark_tpu_torch.air.gadgets import LineaAir, PermutationAirConfig
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.field import fr, oracle
from linea_stark_tpu_torch.field.constants import R_MOD
from linea_stark_tpu_torch.hash import keccak as kk
from linea_stark_tpu_torch.hash import native_engine as ne
from linea_stark_tpu_torch.hash.hasher import KeccakHasher, _digest_words_to_field_mont
from linea_stark_tpu_torch.kernels import keccak as kc
from linea_stark_tpu_torch.merkle import mmcs
from linea_stark_tpu_torch.prover import VerificationError, prove, verify
from linea_stark_tpu_torch.prover.proof import Proof
from linea_stark_tpu_torch.trace.raw_trace import build_trace

torch.set_num_threads(1)
GOLDEN_H16 = os.path.join(chip_smoke.HERE, "tests", "data",
                          "golden_perm3x3_h16_b8_keccak.cbor")
AIR = LineaAir((PermutationAirConfig((0, 1, 2), (3, 4, 5), 6, 7),))
REF_CFG = RefConfig(fri=RefFri(log_blowup=3, log_final_poly_len=0, num_queries=33,
                               proof_of_work_bits=0), hasher="keccak")
EDGES = [0, 1, R_MOD - 1, R_MOD - 2]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _ref_air():
    from linea_stark_tpu.air.gadgets import LineaAir as RefAir
    from linea_stark_tpu.air.gadgets import PermutationAirConfig as RefPerm

    return RefAir((RefPerm((0, 1, 2), (3, 4, 5), 6, 7),))


def _words(msgs: np.ndarray) -> torch.Tensor:
    """(N, 8K) uint8 messages -> (K, N) int64 little-endian message words."""
    return torch.from_numpy(np.ascontiguousarray(msgs.view("<u8").view(np.int64).T))


def _digests(out: torch.Tensor) -> list:
    """(4, N) int64 digest words -> N 32-byte digests."""
    w = out.numpy().view(np.uint64)
    return [b"".join(int(w[j, b]).to_bytes(8, "little") for j in range(4))
            for b in range(w.shape[1])]


def test_known_vectors():
    assert kk.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert kk.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")


@pytest.mark.parametrize("k", [4, 8, 16, 17, 32])
def test_fixed_vec_matches_host_oracle(k):
    msgs = np.random.default_rng(k).integers(0, 256, (6, 8 * k), dtype=np.uint8)
    assert _digests(kk.keccak256_fixed_vec(_words(msgs))) == [
        kk.keccak256(m.tobytes()) for m in msgs]


@pytest.mark.parametrize("k", [8, 17])
def test_fixed_vec_matches_reference(k):
    """Against the reference's jnp version on (lo, hi) u32 pairs."""
    msgs = np.random.default_rng(100 + k).integers(0, 256, (4, 8 * k), dtype=np.uint8)
    words = _words(msgs).numpy().view(np.uint64)  # (K, N)
    pairs = np.stack([words & np.uint64(0xFFFFFFFF), words >> np.uint64(32)],
                     axis=1).astype(np.uint32)  # (K, 2, N)
    ref = np.asarray(ref_fixed_vec(jnp.asarray(pairs))).astype(np.uint64)
    ref64 = (ref[:, 0] | (ref[:, 1] << np.uint64(32))).view(np.int64)
    np.testing.assert_array_equal(kk.keccak256_fixed_vec(_words(msgs)).numpy(), ref64)


def _cols(w, n, seed):
    rng = random.Random(seed)
    vals = [[rng.randrange(R_MOD) for _ in range(n)] for _ in range(w)]
    vals[0][:4] = EDGES
    vals[-1][4:8] = EDGES
    return vals


@pytest.mark.parametrize("w", [2, 4, 8])
def test_hasher_matches_reference_ints(w):
    n = 16
    ref = RefKeccakHasher()
    vals = _cols(w, n, seed=w)
    m = torch.stack([fr.pack_ints(v) for v in vals], dim=1)  # (8, W, N)
    h = KeccakHasher()
    want = [ref.hash_ints([vals[c][j] for c in range(w)]) for j in range(n)]
    assert fr.unpack_ints(h.hash_matrix(m)) == want
    assert fr.unpack_ints(h.hash_columns([m[:, c] for c in range(w)])) == want
    assert fr.unpack_ints(h.compress(m[:, 0], m[:, -1])) == [
        ref.compress_ints(a, b) for a, b in zip(vals[0], vals[-1])]
    assert fr.unpack_ints(h.merkle_level(m[:, 0])) == [
        ref.compress_ints(vals[0][2 * j], vals[0][2 * j + 1]) for j in range(n // 2)]


def test_digest_words_at_or_above_r_reduce():
    vals = [R_MOD, R_MOD + 1, (1 << 256) - 1, 8 * R_MOD + 3]
    digests = [v.to_bytes(32, "big") for v in vals]
    dw = np.array([[int.from_bytes(d[8 * k:8 * k + 8], "little") for d in digests]
                   for k in range(4)], dtype=np.uint64)
    got = _digest_words_to_field_mont(torch.from_numpy(dw.view(np.int64)))
    assert fr.unpack_ints(got) == [v % R_MOD for v in vals]


def test_mmcs_commit_and_openings_match_reference_engine():
    w, n = 2, 16
    vals = _cols(w, n, seed=31)
    mat = torch.stack([fr.pack_ints(v) for v in vals], dim=1)
    tree = mmcs.commit([mat], KeccakHasher())
    d = ref_ne.kc_hash_columns(np.stack([ref_ne.ints_to_u64(v) for v in vals]))
    root = ref_ne.u64_to_ints(ref_ne.kc_tree_levels(d)[-1])[0]
    assert tree.root_int() == root
    openings = mmcs.open_at(tree, [0, 7, 15])
    assert mmcs.verify_openings_batch([(root, (n, w), op) for op in openings],
                                      KeccakHasher())
    bad = copy.deepcopy(openings[1])
    bad.rows[0][0] ^= 1
    assert not mmcs.verify_openings_batch([(root, (n, w), bad)], KeccakHasher())


def test_native_keccak_sweeps_match_reference_and_refuse_wide_rows():
    rng = random.Random(7)
    cols = np.stack([ne.ints_to_u64([rng.randrange(R_MOD) for _ in range(4)])
                     for _ in range(5)])
    np.testing.assert_array_equal(ne.kc_hash_columns(cols), ref_ne.kc_hash_columns(cols))
    np.testing.assert_array_equal(ne.kc_compress(cols[0], cols[1]),
                                  ref_ne.kc_compress(cols[0], cols[1]))
    with pytest.raises(ValueError, match="64 columns"):
        ne.kc_hash_columns(np.zeros((65, 2, 4), np.uint64))


def test_wrapper_plain_path_covers_every_mode():
    """CPU tensors run the plain composition (strided views included)."""
    vals = _cols(3, 8, seed=5)
    m = torch.stack([fr.pack_ints(v) for v in vals], dim=1)
    cols = [m[:, c] for c in range(3)]
    assert torch.equal(kc.hash_columns(cols), kc.hash_columns_plain(cols))
    with pytest.raises(ValueError):
        kc.hash_columns([])


def _port_proof(log_h):
    config, raw, alpha, delta = chip_smoke.bench_inputs(log_h, "keccak")
    built = build_trace([raw], [], alpha, delta, check=False, device="cpu")
    return config, alpha, delta, prove(config, built.air, built.matrix, [alpha, delta],
                                       HashChallenger())


def _tampered(proof):
    bad = copy.deepcopy(proof)
    bad.trace_at_zeta[0] = oracle.add(bad.trace_at_zeta[0], 1)
    return bad


def test_h16_proof_bytes_equal_reference_golden_and_cross_verify():
    config, alpha, delta, proof = _port_proof(4)
    data = proof.to_bytes()
    assert data == _read(GOLDEN_H16)
    ref_verify(REF_CFG, _ref_air(), RefProof.from_bytes(data), [alpha, delta],
               RefChallenger())
    verify(config, AIR, Proof.from_bytes(_read(GOLDEN_H16)), [alpha, delta],
           HashChallenger())
    bad = _tampered(proof)
    with pytest.raises(VerificationError):
        verify(config, AIR, bad, [alpha, delta], HashChallenger())
    with pytest.raises(RefVerificationError):
        ref_verify(REF_CFG, _ref_air(), RefProof.from_bytes(bad.to_bytes()),
                   [alpha, delta], RefChallenger())


def test_h4096_golden_verifies_with_both_verifiers():
    config, _raw, alpha, delta = chip_smoke.bench_inputs(12, "keccak")
    data = _read(chip_smoke.GOLDEN_KECCAK)
    proof = Proof.from_bytes(data)
    assert proof.log_n == 12 and proof.to_bytes() == data
    verify(config, AIR, proof, [alpha, delta], HashChallenger())
    ref_verify(REF_CFG, _ref_air(), RefProof.from_bytes(data), [alpha, delta],
               RefChallenger())


def _ref_proof_bytes(log_h) -> bytes:
    """The reference's proof, run op by op: XLA-CPU compiles of its Keccak
    tree scan take longer than the whole eager prove (the bytes are the
    same either way)."""
    import jax

    from linea_stark_tpu.prover import prove as ref_prove
    from linea_stark_tpu.trace import build_trace as ref_build_trace

    _config, raw, alpha, delta = chip_smoke.bench_inputs(log_h, "keccak")
    with jax.disable_jit():
        built = ref_build_trace([raw], [], alpha, delta, check=False)
        return ref_prove(REF_CFG, built.air, built.matrix, [alpha, delta],
                         RefChallenger()).to_bytes()


@pytest.mark.slow  # ~80 s of eager XLA-CPU ops (a jitted run had not finished in 35 min)
def test_reference_regenerates_h16_golden():
    assert _ref_proof_bytes(4) == _read(GOLDEN_H16)


@pytest.mark.slow  # ~210 s of eager XLA-CPU ops
def test_reference_regenerates_h4096_golden():
    assert _ref_proof_bytes(12) == _read(chip_smoke.GOLDEN_KECCAK)


@pytest.mark.slow  # ~20 s of plain int64 Keccak and field ops at an LDE of 2^15
def test_port_cpu_reproduces_h4096_golden():
    assert _port_proof(12)[3].to_bytes() == _read(chip_smoke.GOLDEN_KECCAK)
