#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``linea_stark_tpu_torch``).

Drives the port's main path once on one CUDA card:

0. environment: torch and CUDA versions, the card's name and power limit;
1. build the CUDA kernels from ``linea_stark_tpu_torch/csrc/``;
2. hold every kernel entry point against its plain PyTorch version on the
   card at the main path's shapes (exact equality) and time both;
3. prove the golden configuration (3x3 permutation AIR, 2^12 rows) and
   require its bytes to equal ``tests/data/golden_perm3x3_h4096_b8.cbor``;
4. the main path: ``bench.py``'s default workload (3x3 permutation AIR at
   2^19 rows, blowup 8, 33 queries, no PoW, Poseidon2, native transcript):
   one warm-up prove, one timed prove with the span tree, verify, and
   reject a tampered proof; every kernel must have launched in the timed
   prove.

Each phase prints one line of numbers; any failure raises.  The line before
the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Run: ``python3 chip_smoke.py``.
``tests/test_torch_cuda.py`` runs phase 2 at small shapes (a quick check).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "golden_perm3x3_h4096_b8.cbor")
REPLACES = {
    "fr_binop": "linea_stark_tpu/kernels/pallas_field.py:74",
    "fr_weighted_colsum": "linea_stark_tpu/kernels/pallas_field.py:195",
    "ntt_stage": "linea_stark_tpu/kernels/pallas_ntt.py:106",
    "p2_permute": "linea_stark_tpu/kernels/pallas_poseidon2.py:202",
    "p2_permute2": "linea_stark_tpu/kernels/pallas_poseidon2.py:247",
    "p2_merkle_level": "linea_stark_tpu/kernels/pallas_poseidon2.py:402",
}
SOURCES = {
    "fr_binop": "linea_stark_tpu_torch/csrc/field_ops.cu",
    "fr_weighted_colsum": "linea_stark_tpu_torch/csrc/field_ops.cu",
    "ntt_stage": "linea_stark_tpu_torch/csrc/ntt.cu",
    "p2_permute": "linea_stark_tpu_torch/csrc/poseidon2.cu",
    "p2_permute2": "linea_stark_tpu_torch/csrc/poseidon2.cu",
    "p2_merkle_level": "linea_stark_tpu_torch/csrc/poseidon2.cu",
}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _rand_field(shape, gen, device):
    """Canonical random field words (top word < r's top word) with the edge
    values 0, 1 and r-1 planted at the front of the last axis."""
    import torch

    from linea_stark_tpu_torch.field import fr
    from linea_stark_tpu_torch.field.constants import R_MOD

    x = torch.randint(-(1 << 31), 1 << 31, (8, *shape), generator=gen,
                      dtype=torch.int64, device="cpu").to(torch.int32)
    x[7] &= 0x0FFFFFFF
    flat = x.reshape(8, -1)
    edges = fr.pack_ints([0, 1, R_MOD - 1, R_MOD - 2], mont=False)
    flat[:, : edges.shape[1]] = edges
    return x.to(device)


def _time_ms(fn, reps: int):
    """(mean ms per call over ``reps`` calls after one warm-up, last output)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _time_once_ms(fn):
    """(ms of one call, its output): the plain versions are timed cold."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _max_err(got, want) -> int:
    return int((got.to("cpu").long() - want.to("cpu").long()).abs().max())


def _as_list(x):
    return list(x) if isinstance(x, tuple) else [x]


def check_kernels(device, small: bool) -> list:
    """Phase 2: every kernel entry point against its plain version on the
    card, at the main path's shapes, with exact equality."""
    import torch

    from linea_stark_tpu_torch.hash.poseidon2 import DEFAULT_PARAMS as P
    from linea_stark_tpu_torch.kernels import field_ops as kf
    from linea_stark_tpu_torch.kernels import ntt as kn
    from linea_stark_tpu_torch.kernels import poseidon2 as kp
    from linea_stark_tpu_torch.ntt.ntt import _twiddle_table

    gen = torch.Generator().manual_seed(2024)
    log_n = 10 if small else 22  # the trace LDE's column length at 2^19 rows
    n = 1 << log_n
    w = 8
    rows = []

    def record(name, shape, kern_fn, plain_fn, extra=()):
        """Time kern_fn (mean of 5) and plain_fn (once); their outputs and the
        (kernel, plain) ``extra`` pairs must be equal."""
        ms, got = _time_ms(kern_fn, 5)
        plain_ms, want = _time_once_ms(plain_fn)
        pairs = list(zip(_as_list(got), _as_list(want))) + list(extra)
        err = max(_max_err(k, p) for k, p in pairs)
        bad = [i for i, (k, p) in enumerate(pairs) if not torch.equal(k.cpu(), p.cpu())]
        print(f"kernel {name:18s} shape {shape:26s} max_abs_err {err} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms", flush=True)
        if bad:
            raise AssertionError(f"{name}: kernel disagrees with plain (cases {bad})")
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "max_abs_err": err,
                     "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                     "shape": shape})
        del got, want, pairs
        torch.cuda.empty_cache()

    a = _rand_field((n,), gen, device)
    b = _rand_field((n,), gen, device)
    b[:, 4:8] = a[:, 4:8]  # x - x and x + x pairs
    scal = b[:, 5:6]
    big = _rand_field((2 * n,), gen, device)
    extra = [(kf.binop(op, a, b), kf.binop_plain(op, a, b)) for op in ("add", "sub")]
    extra.append((kf.binop("mul", a, scal, 1, 1), kf.binop_plain("mul", a, scal, 1, 1)))
    extra.append((kf.binop("mul", big, b, 1, n), kf.binop_plain("mul", big, b, 1, n)))
    extra.append((kf.binop("mul", big, b, n, 2), kf.binop_plain("mul", big, b, n, 2)))
    record("fr_binop", f"mul (8,{n})",
           lambda: kf.binop("mul", a, b), lambda: kf.binop_plain("mul", a, b), extra)
    del a, b, big, extra

    mat = _rand_field((w, n), gen, device)
    u = _rand_field((n,), gen, device)
    record("fr_weighted_colsum", f"(8,{w},{n})",
           lambda: kf.weighted_colsum(mat, u), lambda: kf.weighted_colsum_plain(mat, u))
    del u

    table = _twiddle_table(log_n, False, device)
    m4 = 1 << (2 * ((log_n - 2) // 4))
    small_x = _rand_field((w, n // 8), gen, device)
    table_s = _twiddle_table(log_n - 3, True, device)
    extra = [(kn.stage(mat, table, 1, 4), kn.stage_plain(mat, table, 1, 4)),
             (kn.stage(small_x, table_s, 1, 2), kn.stage_plain(small_x, table_s, 1, 2))]
    record("ntt_stage", f"r4 m={m4} (8,{w},{n})",
           lambda: kn.stage(mat, table, m4, 4), lambda: kn.stage_plain(mat, table, m4, 4),
           extra)
    del mat, table, small_x, table_s, extra

    s0, s1, s2 = (_rand_field((n,), gen, device) for _ in range(3))
    record("p2_permute", f"3x(8,{n})",
           lambda: kp.permute(s0, s1, s2, P), lambda: kp.permute_plain(s0, s1, s2, P))
    record("p2_permute2", f"2x(8,{n})",
           lambda: kp.permute2(s0, s1, P), lambda: kp.permute2_plain(s0, s1, P))
    record("p2_merkle_level", f"(8,{n})->(8,{n // 2})",
           lambda: kp.merkle_level(s0, P), lambda: kp.merkle_level_plain(s0, P))
    return rows


def bench_inputs(log_height: int):
    """bench.py's default workload: 3x3 permutation trace, seed 7, and the
    public challenges drawn from random.Random(0xBE7C4)."""
    import random

    from linea_stark_tpu_torch.config import FriConfig, StarkConfig
    from linea_stark_tpu_torch.field.constants import R_MOD
    from linea_stark_tpu_torch.trace.synthetic import gen_permutation_trace

    rng = random.Random(0xBE7C4)
    alpha, delta = rng.randrange(R_MOD), rng.randrange(R_MOD)
    config = StarkConfig(fri=FriConfig(log_blowup=3, log_final_poly_len=0,
                                       num_queries=33, proof_of_work_bits=0))
    raw = gen_permutation_trace(3, 1 << log_height, seed=7)
    return config, raw, alpha, delta


def golden_phase(device) -> None:
    """Phase 3: the 2^12-row golden proof, byte for byte."""
    from linea_stark_tpu_torch.challenger import HashChallenger
    from linea_stark_tpu_torch.prover import prove
    from linea_stark_tpu_torch.trace.raw_trace import build_trace

    config, raw, alpha, delta = bench_inputs(12)
    t0 = time.perf_counter()
    built = build_trace([raw], [], alpha, delta, check=False, device=device)
    proof = prove(config, built.air, built.matrix, [alpha, delta], HashChallenger())
    data = proof.to_bytes()
    dt = time.perf_counter() - t0
    with open(GOLDEN, "rb") as f:
        want = f.read()
    print(f"golden: 2^12 rows prove {dt:.3f} s, {len(data)} bytes, "
          f"equal {data == want}", flush=True)
    if data != want:
        raise AssertionError("golden proof bytes differ")


def main_path(device, kernel_rows) -> dict:
    """Phase 4: bench.py's default workload through the port."""
    import copy

    import torch

    from linea_stark_tpu_torch import kernels
    from linea_stark_tpu_torch.challenger import HashChallenger
    from linea_stark_tpu_torch.field import oracle
    from linea_stark_tpu_torch.prover import VerificationError, prove, verify
    from linea_stark_tpu_torch.trace.raw_trace import build_trace
    from linea_stark_tpu_torch.utils import timing

    config, raw, alpha, delta = bench_inputs(19)
    t0 = time.perf_counter()
    built = build_trace([raw], [], alpha, delta, check=False, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prove(config, built.air, built.matrix, [alpha, delta], HashChallenger())
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    timing.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove(config, built.air, built.matrix, [alpha, delta], HashChallenger())
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated(device)
    print(timing.report(), flush=True)

    t0 = time.perf_counter()
    verify(config, built.air, proof, [alpha, delta], HashChallenger())
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    bad.trace_at_zeta[0] = oracle.add(bad.trace_at_zeta[0], 1)
    try:
        verify(config, built.air, bad, [alpha, delta], HashChallenger())
    except VerificationError:
        rejected = True
    else:
        rejected = False
    print(f"main path: 2^19 rows trace build {build_s:.3f} s, warm-up prove "
          f"{warm_s:.3f} s, prove {prove_s:.3f} s, verify {verify_s:.3f} s, "
          f"peak memory {peak / 2**30:.3f} GiB, tampered rejected {rejected}, "
          f"proof {len(proof.to_bytes())} bytes", flush=True)
    print(f"launches: {json.dumps(launches)}", flush=True)
    if not rejected:
        raise AssertionError("tampered proof was accepted")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
    return {"prove_s": prove_s, "verify_s": verify_s, "peak_bytes": peak}


def main() -> int:
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    smi = _smi()
    print(f"gpu: {smi}", flush=True)
    device = torch.device("cuda", 0)

    from linea_stark_tpu_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    log = cuda_lib.build(force=True)
    cuda_lib.lib()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s, "
          f"{len(regs)} kernels: {' | '.join(regs)}", flush=True)

    rows = check_kernels(device, small=False)
    golden_phase(device)
    main_path(device, rows)
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
