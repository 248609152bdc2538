"""The port's eager phase mode and the field scans it needs, against the JAX
reference on the CPU, exactly.

``LINEA_FUSED=0`` selects the reference's eager phases: the quotient's and
the open's batch inversions take the prefix/suffix form finished by K6
``fr_mul3_scalar``.  Field arithmetic is exact, so every comparison here is
equality (tolerance 0), and the proofs must not change by a byte.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from linea_stark_tpu import fr_ops as ref_fo
from linea_stark_tpu.field import fr as ref_fr
from linea_stark_tpu_torch import fr_ops as fo
from linea_stark_tpu_torch import kernels
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.field import fr, oracle
from linea_stark_tpu_torch.field.constants import R_MOD
from linea_stark_tpu_torch.kernels import field_ops as kf
from linea_stark_tpu_torch.pcs.two_adic_fri import _fused
from linea_stark_tpu_torch.prover import prove

torch.set_num_threads(1)
rng = random.Random(0xEA6E2)
EDGES = [0, 1, R_MOD - 1, R_MOD - 2, (1 << 252) - 1, R_MOD >> 1]
NONZERO_EDGES = EDGES[1:]
DATA = os.path.join(chip_smoke.HERE, "tests", "data")


def _ref_ints(arr):
    return ref_fr.unpack_ints(np.asarray(arr))


def _ref(vals, shape):
    return jnp.asarray(ref_fr.pack_ints(vals).reshape((16,) + shape))


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("reverse", [False, True])
def test_scans_match_reference(op, reverse):
    """Inclusive prefix/suffix products and sums over a (2, 37) batch (an
    odd length, so the last doubling step is partial)."""
    vals = EDGES + [rng.randrange(R_MOD) for _ in range(2 * 37 - len(EDGES))]
    port_fn, ref_fn = ((fo.prefix_product, ref_fo.prefix_product) if op == "mul"
                       else (fo.prefix_sum, ref_fo.prefix_sum))
    got = fr.unpack_ints(port_fn(fr.pack_ints(vals).reshape(8, 2, 37), reverse=reverse))
    assert got == _ref_ints(ref_fn(_ref(vals, (2, 37)), reverse=reverse))
    combine = oracle.mul if op == "mul" else oracle.add
    for row in range(2):
        seq = vals[37 * row:37 * (row + 1)]
        seq = seq[::-1] if reverse else seq
        want, acc = [], None
        for v in seq:
            acc = v if acc is None else combine(acc, v)
            want.append(acc)
        assert got[37 * row:37 * (row + 1)] == (want[::-1] if reverse else want)


def test_batch_inverse_eager_matches_reference():
    n = 300
    vals = NONZERO_EDGES + [rng.randrange(1, R_MOD) for _ in range(n - len(NONZERO_EDGES))]
    want = [oracle.inv(v) for v in vals]
    assert _ref_ints(ref_fo.batch_inverse(_ref(vals, (n,)))) == want
    assert fr.unpack_ints(fo.batch_inverse_eager(fr.pack_ints(vals))) == want
    # any batch shape inverts as one flat batch and keeps its shape
    stacked = fo.batch_inverse_eager(fr.pack_ints(vals).reshape(8, 2, n // 2))
    assert stacked.shape == (8, 2, n // 2) and fr.unpack_ints(stacked) == want
    assert fr.unpack_ints(fo.batch_inverse_eager(fr.pack_ints([R_MOD - 2]))) == [
        oracle.inv(R_MOD - 2)]


@pytest.mark.parametrize("n", [64, 256])
def test_sum_to_ints_matches_reference(n):
    """N = 64 takes tree_sum, N = 256 the K7 route (its plain version here)."""
    w = 3
    cols = [EDGES + [rng.randrange(R_MOD) for _ in range(n - len(EDGES))] for _ in range(w)]
    flat = sum(cols, [])
    got = fo.sum_to_ints(fr.pack_ints(flat).reshape(8, w, n))
    assert got == [sum(c) % R_MOD for c in cols]
    assert got == ref_fo.sum_to_ints(_ref(flat, (w, n)))
    assert fr.unpack_ints(fo.tree_sum(fr.pack_ints(flat[:n - 1]))) == [sum(cols[0][:n - 1]) % R_MOD]


def test_mul3_scalar_plain_matches_oracle():
    n = 40
    a = EDGES + [rng.randrange(R_MOD) for _ in range(n - len(EDGES))]
    b = EDGES[::-1] + [rng.randrange(R_MOD) for _ in range(n - len(EDGES))]
    want = {c: [oracle.mul(oracle.mul(x, y), c) for x, y in zip(a, b)]
            for c in (0, 1, R_MOD - 1, rng.randrange(R_MOD))}
    before = kernels.launches()
    for c, w in want.items():
        args = (fr.pack_ints(a), fr.pack_ints(b), fr.const(c))
        assert fr.unpack_ints(kf.mul3_scalar_plain(*args)) == w
        assert fr.unpack_ints(kf.mul3_scalar(*args)) == w  # CPU: the plain version
    assert kernels.launches() == before


def test_fused_reads_the_environment_at_call_time(monkeypatch):
    monkeypatch.delenv("LINEA_FUSED", raising=False)
    assert _fused()
    monkeypatch.setenv("LINEA_FUSED", "0")
    assert not _fused()
    monkeypatch.setenv("LINEA_FUSED", "1")
    assert _fused()


@pytest.mark.parametrize("hasher,workload,golden", [
    ("keccak", "perm", "golden_perm3x3_h16_b8_keccak.cbor"),
    ("poseidon2", "lookup", "golden_lookup3_h16_b8.cbor"),
])
def test_eager_mode_proof_equals_default_mode(monkeypatch, hasher, workload, golden):
    """The 16-row goldens are the reference's bytes, which the default mode
    reproduces (``test_torch_keccak.py``, ``test_torch_lookup.py``); the
    eager mode must too.  An eager prove runs the K6 finish twice, once for
    the quotient's selector denominators and once for the open's."""
    with open(os.path.join(DATA, golden), "rb") as f:
        default = f.read()
    calls = []

    def counted(a, b, c):
        calls.append(a.shape[1])
        return kf.mul3_scalar_plain(a, b, c)

    monkeypatch.setattr(kf, "mul3_scalar", counted)
    monkeypatch.setenv("LINEA_FUSED", "0")
    config, raw, alpha, delta = chip_smoke.bench_inputs(4, hasher, workload)
    built = chip_smoke.build_bench_trace(raw, alpha, delta, "cpu")
    proof = prove(config, built.air, built.matrix, [alpha, delta], HashChallenger())
    assert proof.to_bytes() == default
    assert calls == [2 * 2 * 16, 2 * 8 * 16]  # 2 cosets x 2 selectors, 2 points x LDE
