"""Port field layer vs the JAX reference on the CPU, exactly.

The port's (8, N) int32 tensors run the plain int64 versions of the kernels
here; the reference runs its XLA limb code.  Inputs come from one seeded
Python RNG and reach both sides through the converters; field results must
match bit for bit (tolerance 0: the arithmetic is exact).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linea_stark_tpu import fr_ops as ref_fo
from linea_stark_tpu.field import fr as ref_fr
from linea_stark_tpu_torch import fr_ops as fo
from linea_stark_tpu_torch import kernels
from linea_stark_tpu_torch.field import fr, oracle
from linea_stark_tpu_torch.field.codec import decode_be_bytes_mod_order
from linea_stark_tpu_torch.field.constants import R_MOD
from linea_stark_tpu_torch.hash import native_engine as ne

torch.set_num_threads(1)
rng = random.Random(0xF1E1D)
N = 64
EDGES = [0, 1, R_MOD - 1, R_MOD - 2, (1 << 252) - 1, R_MOD >> 1]


def rand_vals(n, lo=0):
    return [rng.randrange(lo, R_MOD) for _ in range(n)]


A = EDGES + rand_vals(N - len(EDGES))
B = [R_MOD - 1, 1, R_MOD - 1, 0, R_MOD - 2, 3] + rand_vals(N - len(EDGES))


def ref_dev(vals, mont=True):
    return jnp.asarray(ref_fr.pack_ints(vals, mont=mont))


def ref_ints(arr, mont=True):
    return ref_fr.unpack_ints(np.asarray(arr), mont=mont)


def test_converters_round_trip_all_layouts():
    vals = A
    t = fr.pack_ints(vals)
    assert t.dtype == torch.int32 and tuple(t.shape) == (8, N)
    planes = fr.to_ref_planes(t)
    np.testing.assert_array_equal(planes, ref_fr.pack_ints(vals))
    assert torch.equal(fr.from_ref_planes(planes), t)
    rows = fr.to_u64_rows(t)
    assert rows.shape == (N, 4) and rows.dtype == np.uint64
    np.testing.assert_array_equal(ne.from_mont(rows), ne.ints_to_u64(vals))
    assert torch.equal(fr.from_u64_rows(rows), t)
    assert fr.unpack_ints(t) == vals
    assert fr.unpack_ints(fr.pack_ints(vals, mont=False), mont=False) == vals


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binop_matches_reference(op):
    got = fr.unpack_ints(getattr(fo, op)(fr.pack_ints(A), fr.pack_ints(B)))
    want = ref_ints(getattr(ref_fr, op)(ref_dev(A), ref_dev(B)))
    assert got == want
    assert got == [getattr(oracle, op)(x, y) for x, y in zip(A, B)]


def test_mul_scalar_and_const_match_reference():
    c = rng.randrange(R_MOD)
    want = ref_ints(ref_fr.mul_const(ref_dev(A), c))
    assert fr.unpack_ints(fo.mul_const(fr.pack_ints(A), c)) == want
    assert fr.unpack_ints(fo.mul_scalar_arr(fr.pack_ints(A), fr.const(c))) == want


def test_mont_conversions_match_reference():
    raw = fr.pack_ints(A, mont=False)
    assert torch.equal(fo.to_mont(raw), fr.pack_ints(A))
    got = fr.to_ref_planes(fo.from_mont(fr.pack_ints(A)))
    np.testing.assert_array_equal(got, np.asarray(ref_fr.from_mont(ref_dev(A))))
    np.testing.assert_array_equal(
        fr.to_ref_planes(fo.to_mont(raw)), np.asarray(ref_fr.to_mont(ref_dev(A, mont=False))))


def test_to_mont_reduces_any_256_bit_value():
    big = [(1 << 256) - 1, (1 << 253) - 1, (1 << 253) - 7, R_MOD, 2 * R_MOD + 5]
    big += [rng.randrange(1 << 256) for _ in range(11)]
    words = fr._words_np(np.array(big, dtype=object))
    x = torch.from_numpy(words.view(np.int32))
    assert fr.unpack_ints(fo.to_mont(x)) == [v % R_MOD for v in big]
    data = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in big), np.uint8).reshape(-1, 32)
    assert fr.unpack_ints(decode_be_bytes_mod_order(data, device="cpu")) == [v % R_MOD for v in big]


def test_inv_matches_reference():
    vals = [1, R_MOD - 1] + rand_vals(6, lo=1)
    want = ref_ints(ref_fr.inv(ref_dev(vals)))
    assert fr.unpack_ints(fr.inv(fr.pack_ints(vals))) == want


def test_pow_const():
    vals = rand_vals(8)
    for e in (0, 1, 2, 11, 12345):
        assert fr.unpack_ints(fr.pow_const(fr.pack_ints(vals), e)) == [
            pow(v, e, R_MOD) for v in vals]


def test_powers_match_reference():
    base = rng.randrange(R_MOD)
    got = fr.to_ref_planes(fo.powers(base, 300))
    np.testing.assert_array_equal(got, np.asarray(ref_fo.powers(base, 300)))


@pytest.mark.parametrize("n", [40, 256, 1000])
def test_batch_inverse_matches_reference(n):
    vals = [1, R_MOD - 1] + rand_vals(n - 2, lo=1)
    got = fr.unpack_ints(fo.batch_inverse(fr.pack_ints(vals)))
    assert got == [oracle.inv(v) for v in vals]
    if n == 256:
        want = ref_ints(ref_fr.batch_inverse(ref_dev(vals)))
        assert got == want


def test_batch_inverse_keeps_shape():
    vals = rand_vals(2 * 3 * 70, lo=1)
    x = fr.pack_ints(vals).reshape(8, 2, 3, 70)
    got = fo.batch_inverse(x)
    assert got.shape == x.shape
    assert fr.unpack_ints(got) == [oracle.inv(v) for v in vals]


def test_broadcast_operand_forms():
    """Scalar, shared-table and per-row second operands, as the kernel
    reads them, equal elementwise broadcasting."""
    a = fr.pack_ints(rand_vals(24)).reshape(8, 2, 3, 4)
    row = fr.pack_ints(rand_vals(3)).reshape(8, 3, 1)
    table = fr.pack_ints(rand_vals(4))
    ai = fr.unpack_ints(a)
    ri, ti = fr.unpack_ints(row), fr.unpack_ints(table)
    idx = [(i, j, k) for i in range(2) for j in range(3) for k in range(4)]
    assert fr.unpack_ints(fo.mul(a, row)) == [
        oracle.mul(ai[p], ri[j]) for p, (i, j, k) in enumerate(idx)]
    assert fr.unpack_ints(fo.sub(row, a)) == [
        oracle.sub(ri[j], ai[p]) for p, (i, j, k) in enumerate(idx)]
    assert fr.unpack_ints(fo.add(a, table)) == [
        oracle.add(ai[p], ti[k]) for p, (i, j, k) in enumerate(idx)]
    assert fr.unpack_ints(fo.mul(row, table)) == [
        oracle.mul(ri[j], ti[k]) for j in range(3) for k in range(4)]


def test_weighted_sums_match_reference():
    w, n = 3, 130
    cols = [rand_vals(n) for _ in range(w)]
    u = rand_vals(n)
    mat = fr.pack_ints(sum(cols, [])).reshape(8, w, n)
    got = fo.weighted_sums_to_ints(mat, fr.pack_ints(u))
    assert got == [sum(c[j] * u[j] for j in range(n)) % R_MOD for c in cols]
    ref_mat = jnp.asarray(ref_fr.pack_ints(sum(cols, [])).reshape(16, w, n))
    assert got == ref_fo.weighted_sums_to_ints(ref_mat, ref_dev(u))


def test_cpu_tensors_launch_no_kernel():
    before = kernels.launches()
    fo.mul(fr.pack_ints(A), fr.pack_ints(B))
    fo.weighted_sums_to_ints(fr.pack_ints(A).reshape(8, 1, N), fr.pack_ints(B))
    assert kernels.launches() == before
