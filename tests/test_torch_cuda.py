"""CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports no JAX, so it runs on the GPU machine (which has none) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the suite's conftest imports JAX).
"""

import pytest
import torch

import chip_smoke
from linea_stark_tpu_torch import fr_ops as fo
from linea_stark_tpu_torch import kernels
from linea_stark_tpu_torch.challenger import HashChallenger
from linea_stark_tpu_torch.field import fr
from linea_stark_tpu_torch.kernels import field_ops as kf
from linea_stark_tpu_torch.kernels import keccak as kc
from linea_stark_tpu_torch.prover import prove, verify

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_kernels_match_plain_small_shapes(cuda):
    rows = chip_smoke.check_kernels(cuda, small=True, costs=chip_smoke.probe_costs(),
                                    clock_mhz=chip_smoke.max_sm_clock_mhz())
    assert [r["name"] for r in rows] == list(kernels.LAUNCHES)
    assert all(r["max_abs_err"] == 0 for r in rows)
    modes = {r["name"]: len(r.get("modes", [r])) for r in rows}
    assert modes["kc_hash"] == 4  # leaves x2, level, compress
    assert modes["fr_mul3_scalar"] == 2  # the open's and the quotient's shapes


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = fr.pack_ints([1, 2, 3, 4]).to(cuda)
    with pytest.raises(ValueError):
        kf.binop("mul", a.to(torch.int64), a)
    with pytest.raises(ValueError):
        kf.binop("mul", a[:, ::2], a)
    with pytest.raises(ValueError):
        kf.binop("mul", a, a[:, :2])
    with pytest.raises(ValueError):
        kc.hash_columns([a] * (kc.MAX_COLUMNS + 1))
    with pytest.raises(ValueError):
        kc.hash_columns([a, a[:, :2]])
    with pytest.raises(ValueError):
        kc.hash_columns([a, a.to(torch.int64)])
    with pytest.raises(ValueError):
        kf.mul3_scalar(a, a[:, :2], a[:, 0])
    with pytest.raises(ValueError):
        kf.mul3_scalar(a, a, a[:, 0].to(torch.int64))
    with pytest.raises(ValueError):
        kf.colsum(a)  # not (8, W, N)


def test_sum_to_ints_on_cuda_launches_colsum(cuda):
    x = fr.pack_ints(list(range(1, 2 * 300 + 1))).reshape(8, 2, 300)
    kernels.reset_launches()
    got = fo.sum_to_ints(x.to(cuda))
    assert kernels.launches()["fr_colsum"] == 1
    assert got == fo.sum_to_ints(x) == [sum(range(1, 301)), sum(range(301, 601))]


@pytest.mark.parametrize("path,hasher,workload,fused", [
    ("poseidon2", "poseidon2", "perm", "1"),
    ("keccak", "keccak", "perm", "1"),
    ("lookup", "poseidon2", "lookup", "1"),
    ("eager", "poseidon2", "lookup", "0"),
])
def test_prove_on_cuda_equals_cpu_bytes(cuda, monkeypatch, path, hasher, workload, fused):
    monkeypatch.setenv("LINEA_FUSED", fused)
    config, raw, alpha, delta = chip_smoke.bench_inputs(4, hasher, workload)
    proofs = []
    for dev in (torch.device("cpu"), cuda):
        built = chip_smoke.build_bench_trace(raw, alpha, delta, dev)
        kernels.reset_launches()
        proofs.append(prove(config, built.air, built.matrix, [alpha, delta], HashChallenger()))
    launches = kernels.launches()
    assert all(launches[k] > 0 for k in chip_smoke.PATH_KERNELS[path])
    assert launches["fr_colsum"] == 0
    assert proofs[0].to_bytes() == proofs[1].to_bytes()
    verify(config, built.air, proofs[1], [alpha, delta], HashChallenger())
