#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``linea_stark_tpu_torch``).

Drives the port's main paths once on one CUDA card:

0. environment: torch and CUDA versions, the card's name, power limit and
   maximum SM clock;
1. build the CUDA kernels from ``linea_stark_tpu_torch/csrc/`` (one ``nvcc``
   per source, side by side) and, beside them, a probe whose SASS
   instruction counts give each kernel's operation bound;
2. hold every kernel entry point against its plain PyTorch version on the
   card at the main paths' shapes (exact equality), time both and state
   each kernel's bound;
3. prove the golden configuration (3x3 permutation AIR, 2^12 rows) and
   require its bytes to equal ``tests/data/golden_perm3x3_h4096_b8.cbor``;
4. the main path: ``bench.py``'s default workload (3x3 permutation AIR at
   2^19 rows, blowup 8, 33 queries, no PoW, Poseidon2, native transcript):
   one warm-up prove, one timed prove with the span tree, verify, and
   reject a tampered proof; every kernel of the path must have launched in
   the timed prove;
5. the Keccak golden: phase 3 with the Keccak MMCS, held to
   ``tests/data/golden_perm3x3_h4096_b8_keccak.cbor``;
6. the Keccak main path: phase 4 with ``BENCH_HASHER=keccak``;
7. the lookup golden: ``bench.py``'s ``BENCH_WORKLOAD=lookup`` workload (a
   3-column LogUp lookup into one 3-column table, 12 trace columns) at 2^12
   rows, held to ``tests/data/golden_lookup3_h4096_b8.cbor``;
8. the lookup main path: phase 4 with that workload at 2^19 rows;
9. the eager phase mode (``LINEA_FUSED=0``, restored afterwards): phase 3's
   golden again, then phase 8, whose prove must launch ``fr_mul3_scalar``
   at least twice (the quotient's and the open's batch inversions).

Each phase prints its numbers; any failure raises.  The line before the
last is the kernel table as JSON, the last line ``{"ok": true, "device":
{...}}``.  Run: ``python3 chip_smoke.py``.  ``tests/test_torch_cuda.py``
runs phase 2 at small shapes (a quick check).
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "golden_perm3x3_h4096_b8.cbor")
GOLDEN_KECCAK = os.path.join(HERE, "tests", "data", "golden_perm3x3_h4096_b8_keccak.cbor")
GOLDEN_LOOKUP = os.path.join(HERE, "tests", "data", "golden_lookup3_h4096_b8.cbor")
REPLACES = {
    "fr_binop": "linea_stark_tpu/kernels/pallas_field.py:74",
    "fr_weighted_colsum": "linea_stark_tpu/kernels/pallas_field.py:195",
    "ntt_stage": "linea_stark_tpu/kernels/pallas_ntt.py:106",
    "p2_permute": "linea_stark_tpu/kernels/pallas_poseidon2.py:202",
    "p2_permute2": "linea_stark_tpu/kernels/pallas_poseidon2.py:247",
    "p2_merkle_level": "linea_stark_tpu/kernels/pallas_poseidon2.py:402",
    "kc_hash": "linea_stark_tpu/hash/hasher.py:143",
    "fr_mul3_scalar": "linea_stark_tpu/kernels/pallas_field.py:241",
    "fr_colsum": "linea_stark_tpu/kernels/pallas_field.py:133",
}
SOURCES = {
    "fr_binop": "linea_stark_tpu_torch/csrc/field_ops.cu",
    "fr_weighted_colsum": "linea_stark_tpu_torch/csrc/field_ops.cu",
    "ntt_stage": "linea_stark_tpu_torch/csrc/ntt.cu",
    "p2_permute": "linea_stark_tpu_torch/csrc/poseidon2.cu",
    "p2_permute2": "linea_stark_tpu_torch/csrc/poseidon2.cu",
    "p2_merkle_level": "linea_stark_tpu_torch/csrc/poseidon2.cu",
    "kc_hash": "linea_stark_tpu_torch/csrc/keccak.cu",
    "fr_mul3_scalar": "linea_stark_tpu_torch/csrc/field_ops.cu",
    "fr_colsum": "linea_stark_tpu_torch/csrc/field_ops.cu",
}
# Kernels each main path must launch (the Keccak path hashes with K5 only;
# its challenger, like the reference's, is Poseidon2 over host ints).  No
# prove path runs K7 ``fr_colsum``: only a direct ``fr_ops.sum_to_ints``
# reaches it, as only a direct call reaches the reference's block_sums_128.
_P2_PATH = ["fr_binop", "fr_weighted_colsum", "ntt_stage", "p2_permute",
            "p2_permute2", "p2_merkle_level"]
PATH_KERNELS = {
    "poseidon2": _P2_PATH,
    "keccak": ["fr_binop", "fr_weighted_colsum", "ntt_stage", "kc_hash"],
    "lookup": _P2_PATH,
    "eager": _P2_PATH + ["fr_mul3_scalar"],
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# SMs x thread-instructions issued per SM and clock (4 schedulers x 32
# lanes): the ceiling over all pipes, so no mix of SASS runs faster
ISSUE_LANES = 132 * 128

# Straight-line probes of the kernels' building blocks; their SASS
# instruction counts, less a load/store skeleton, price one operation.
PROBE_SOURCE = r"""
#include <stdint.h>
#include "keccak.cu"

#define FE2(body) { const fr::fe x = fr::load(a, 1, 0), y = fr::load(a + 8, 1, 0); \
                    fr::store(o, 1, 0, body); }
extern "C" __global__ void probe_base(const uint32_t* a, uint32_t* o) {
  const fr::fe x = fr::load(a, 1, 0), y = fr::load(a + 8, 1, 0);
  fr::fe z;
  for (int k = 0; k < fr::W; k++) z.v[k] = x.v[k] ^ y.v[k];
  fr::store(o, 1, 0, z);
}
extern "C" __global__ void probe_mul(const uint32_t* a, uint32_t* o) FE2(fr::mul(x, y))
extern "C" __global__ void probe_add(const uint32_t* a, uint32_t* o) FE2(fr::add(x, y))
extern "C" __global__ void probe_sub(const uint32_t* a, uint32_t* o) FE2(fr::sub(x, y))
extern "C" __global__ void probe_copy(const uint32_t* a, uint32_t* o) {
  fr::store(o, 1, 0, fr::load(a, 1, 0));
}
extern "C" __global__ void probe_from_mont(const uint32_t* a, uint32_t* o) {
  fr::fe one = fr::zero();
  one.v[0] = 1;
  fr::store(o, 1, 0, fr::mul(fr::load(a, 1, 0), one));
}
extern "C" __global__ void probe_to_mont(const uint32_t* a, uint32_t* o) {
  fr::store(o, 1, 0, fr::mul(fr::load(a, 1, 0), mont_r2()));
}
extern "C" __global__ void probe_lanes(const uint64_t* a, uint64_t* o) {
  uint64_t s[25];
  for (int i = 0; i < 25; i++) s[i] = a[i];
  for (int i = 0; i < 25; i++) o[i] = s[i];
}
extern "C" __global__ void probe_keccak_f(const uint64_t* a, uint64_t* o) {
  uint64_t s[25];
  for (int i = 0; i < 25; i++) s[i] = a[i];
  keccak_f(s);
  for (int i = 0; i < 25; i++) o[i] = s[i];
}
"""
_PROBES = {"mul": "base", "add": "base", "sub": "base", "from_mont": "copy",
           "to_mont": "copy", "keccak_f": "lanes"}
_SASS_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def _smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuobjdump() -> str:
    """``cuobjdump`` beside ``nvcc``, on the PATH or in Triton's package."""
    from linea_stark_tpu_torch.kernels import cuda_lib

    cands = [os.path.join(os.path.dirname(cuda_lib.nvcc_path()), "cuobjdump"),
             shutil.which("cuobjdump") or ""]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError("cuobjdump not found: cannot count SASS instructions")


def start_probe_build():
    """Start compiling the probe to a cubin (runs beside the kernel build)."""
    from linea_stark_tpu_torch.kernels import cuda_lib
    from linea_stark_tpu_torch.utils.build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, "sass_probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    cubin = os.path.join(BUILD_DIR, "sass_probe.cubin")
    cmd = [cuda_lib.nvcc_path(), cuda_lib.ARCH, "-std=c++17", "-O3", "-cubin",
           "-I", cuda_lib.CSRC, "-o", cubin, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cubin


def probe_costs() -> dict:
    """Build the probe and count its SASS (:func:`finish_probe_build`)."""
    return finish_probe_build(start_probe_build())


def max_sm_clock_mhz() -> float:
    return float(_smi("clocks.max.sm").split()[0])


def finish_probe_build(job) -> dict:
    """SASS instructions of one operation, per thread: {"mul": ..., ...}."""
    proc, cubin = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{out}")
    sass = subprocess.run([_cuobjdump(), "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
            continue
        m = _SASS_INSN.match(line)
        if cur and m and m.group(1) != "NOP":
            counts[cur] += 1
    return {op: counts[f"probe_{op}"] - counts[f"probe_{base}"]
            for op, base in _PROBES.items()}


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier (and template radix) of a mangled name:
    walk its <length><identifier> parts."""
    i = 0
    while True:
        m = re.compile(r"\d+").search(mangled, i)
        if m is None:
            return mangled
        start = m.end()
        ident = mangled[start:start + int(m.group())]
        if ident.endswith("_kernel"):
            t = re.compile(r"ILi(\d+)E").match(mangled, start + len(ident))
            return ident + (f"<{t.group(1)}>" if t else "")
        i = start + max(len(ident), 1)


def ptxas_summary(log: str) -> list:
    """'kernel: N registers, S B spill stores' for each entry function in
    ``nvcc -Xptxas -v`` output."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores")
            name, spill = None, "?"
    return out


def bound(nbytes: float, instrs: float, clock_mhz: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and SASS
    instructions over the card's instruction issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = instrs / (ISSUE_LANES * clock_mhz * 1e6)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _rand_field(shape, gen, device):
    """Canonical random field words (top word < r's top word) with the edge
    values 0, 1, r-1 and r-2 planted at the front of the last axis."""
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
    """(mean ms per call over ``reps`` calls after two warm-ups, last output).

    The loop's outputs alternate between two allocations; two warm-ups leave
    both in the caching allocator, so no ``cudaMalloc`` lands in the timed
    loop."""
    import torch

    out = fn()
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
    """(ms of one call after one untimed call, its output): the plain
    versions are slow, so they are timed once, but not cold (a first call
    also pays PyTorch's lazy loading of its CUDA modules)."""
    import torch

    fn()
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


def check_kernels(device, small: bool, costs: dict, clock_mhz: float) -> list:
    """Phase 2: every kernel entry point against its plain version on the
    card, at the main paths' shapes, with exact equality.  ``costs`` are the
    probe's SASS instructions per operation (:func:`finish_probe_build`)."""
    import torch

    from linea_stark_tpu_torch.hash.keccak import RATE_BYTES
    from linea_stark_tpu_torch.hash.poseidon2 import DEFAULT_PARAMS as P
    from linea_stark_tpu_torch.kernels import field_ops as kf
    from linea_stark_tpu_torch.kernels import keccak as kc
    from linea_stark_tpu_torch.kernels import ntt as kn
    from linea_stark_tpu_torch.kernels import poseidon2 as kp
    from linea_stark_tpu_torch.ntt.ntt import _twiddle_table

    gen = torch.Generator().manual_seed(2024)
    log_n = 10 if small else 22  # the trace LDE's column length at 2^19 rows
    n = 1 << log_n
    w = 8
    fe = 32  # bytes of one field element
    rows = []

    def measure(name, shape, kern_fn, plain_fn, nbytes, instrs):
        """Time kern_fn (mean of 5) and plain_fn (once); their outputs must
        be equal.  ``nbytes`` and ``instrs`` give the bound."""
        ms, got = _time_ms(kern_fn, 5)
        plain_ms, want = _time_once_ms(plain_fn)
        pairs = list(zip(_as_list(got), _as_list(want)))
        err = max(_max_err(k, p) for k, p in pairs)
        bad = [i for i, (k, p) in enumerate(pairs) if not torch.equal(k.cpu(), p.cpu())]
        bound_ms, bound_by = bound(nbytes, instrs, clock_mhz)
        print(f"kernel {name:18s} shape {shape:26s} max_abs_err {err} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.3f} ms "
              f"({bound_by}; {nbytes / 1e6:.1f} MB, {instrs / 1e9:.2f} G instr)",
              flush=True)
        if bad:
            raise AssertionError(f"{name} {shape}: kernel disagrees with plain (cases {bad})")
        del got, want, pairs
        torch.cuda.empty_cache()
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "max_abs_err": err, "ms": round(ms, 4),
                "plain_ms": round(plain_ms, 4), "bound_ms": round(bound_ms, 4),
                "bound_by": bound_by, "library_ms": None, "shape": shape}

    def row_of(modes):
        """One JSON row per kernel: its first (main-path) mode, with every
        mode's numbers under "modes"."""
        row = dict(modes[0])
        row["max_abs_err"] = max(m["max_abs_err"] for m in modes)
        if len(modes) > 1:
            row["modes"] = [{k: m[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                               "bound_by")} for m in modes]
        return row

    a = _rand_field((n,), gen, device)
    b = _rand_field((n,), gen, device)
    b[:, 4:8] = a[:, 4:8]  # x - x and x + x pairs
    scal = b[:, 5:6]
    big = _rand_field((2 * n,), gen, device)
    binops = [  # (shape, op, a, b, div, mod, bytes, instrs)
        (f"mul (8,{n})", "mul", a, b, 1, n, 3 * fe * n, n * costs["mul"]),
        (f"add (8,{n})", "add", a, b, 1, n, 3 * fe * n, n * costs["add"]),
        (f"sub (8,{n})", "sub", a, b, 1, n, 3 * fe * n, n * costs["sub"]),
        (f"mul scalar (8,{n})", "mul", a, scal, 1, 1, fe * (2 * n + 1), n * costs["mul"]),
        (f"mul table (8,{2 * n})x(8,{n})", "mul", big, b, 1, n, fe * 5 * n,
         2 * n * costs["mul"]),
        (f"mul per-row (8,{2 * n})x(8,2)", "mul", big, b, n, 2, fe * (4 * n + 2),
         2 * n * costs["mul"]),
    ]
    rows.append(row_of([
        measure("fr_binop", shape, lambda op=op, x=x, y=y, d=d, m=m: kf.binop(op, x, y, d, m),
                lambda op=op, x=x, y=y, d=d, m=m: kf.binop_plain(op, x, y, d, m), nb, ins)
        for shape, op, x, y, d, m, nb, ins in binops]))
    del a, b, big, binops

    mat = _rand_field((w, n), gen, device)
    u = _rand_field((n,), gen, device)
    rows.append(measure("fr_weighted_colsum", f"(8,{w},{n})",
                        lambda: kf.weighted_colsum(mat, u),
                        lambda: kf.weighted_colsum_plain(mat, u),
                        fe * (w * n + n + w), w * n * (costs["mul"] + costs["add"])))
    del u

    table = _twiddle_table(log_n, False, device)
    m4 = 1 << (2 * ((log_n - 2) // 4))
    small_x = _rand_field((w, n // 8), gen, device)
    table_s = _twiddle_table(log_n - 3, True, device)
    r4 = 4 * costs["mul"] + 4 * costs["add"] + 4 * costs["sub"]  # per butterfly
    r2 = costs["mul"] + costs["add"] + costs["sub"]
    stages = [  # (shape, x, table, m, radix, bytes, instrs)
        (f"r4 m={m4} (8,{w},{n})", mat, table, m4, 4,
         fe * (2 * w * n + table.shape[1]), w * n // 4 * r4),
        (f"r4 m=1 (8,{w},{n})", mat, table, 1, 4,
         fe * (2 * w * n + table.shape[1]), w * n // 4 * r4),
        (f"r2 m=1 (8,{w},{n // 8})", small_x, table_s, 1, 2,
         fe * (2 * w * n // 8 + table_s.shape[1]), w * n // 16 * r2),
    ]
    rows.append(row_of([
        measure("ntt_stage", shape, lambda x=x, t=t, m=m, r=r: kn.stage(x, t, m, r),
                lambda x=x, t=t, m=m, r=r: kn.stage_plain(x, t, m, r), nb, ins)
        for shape, x, t, m, r, nb, ins in stages]))
    del table, small_x, table_s, stages

    perm = (5 * (3 * P.rounds_f + P.rounds_p) * costs["mul"]
            + (5 + 8 * P.rounds_f + 7 * P.rounds_p) * costs["add"])  # per state
    s0, s1, s2 = (_rand_field((n,), gen, device) for _ in range(3))
    rows.append(measure("p2_permute", f"3x(8,{n})",
                        lambda: kp.permute(s0, s1, s2, P),
                        lambda: kp.permute_plain(s0, s1, s2, P), 6 * fe * n, n * perm))
    rows.append(measure("p2_permute2", f"2x(8,{n})",
                        lambda: kp.permute2(s0, s1, P),
                        lambda: kp.permute2_plain(s0, s1, P), 5 * fe * n, n * perm))
    rows.append(measure("p2_merkle_level", f"(8,{n})->(8,{n // 2})",
                        lambda: kp.merkle_level(s0, P),
                        lambda: kp.merkle_level_plain(s0, P), 3 * fe * n // 2,
                        n // 2 * perm))
    del s0, s1, s2

    def kc_instrs(width, count):
        blocks = (32 * width) // RATE_BYTES + 1
        return count * (blocks * costs["keccak_f"] + width * costs["from_mont"]
                        + costs["to_mont"])

    # the four modes at the Keccak path's shapes; the row is the trace leaves
    mat4 = _rand_field((4, n // 4), gen, device)
    d = _rand_field((n,), gen, device)
    left, right = d[:, : n // 2].contiguous(), d[:, n // 2:].contiguous()
    cases = [
        (f"leaves (8,{w},{n})", [mat[:, c] for c in range(w)], w, n),
        (f"leaves (8,4,{n // 4})", [mat4[:, c] for c in range(4)], 4, n // 4),
        (f"level (8,{n})->(8,{n // 2})", [d[:, 0::2], d[:, 1::2]], 2, n // 2),
        (f"compress 2x(8,{n // 2})", [left, right], 2, n // 2),
    ]
    rows.append(row_of([
        measure("kc_hash", shape, lambda cols=cols: kc.hash_columns(cols),
                lambda cols=cols: kc.hash_columns_plain(cols),
                fe * (width + 1) * count, kc_instrs(width, count))
        for shape, cols, width, count in cases]))
    del mat4, d, left, right, cases

    # K6 at the eager batch inversions' shapes: the open's (ζ−x, ζg−x) stack
    # of 2·n_lde and the quotient's two selector denominators over 2 cosets
    muls = []
    for size in (2 * n, n // 2):
        x = _rand_field((size,), gen, device)
        y = _rand_field((size,), gen, device)
        c = y[:, 6]
        muls.append(measure("fr_mul3_scalar", f"(8,{size})",
                            lambda x=x, y=y, c=c: kf.mul3_scalar(x, y, c),
                            lambda x=x, y=y, c=c: kf.mul3_scalar_plain(x, y, c),
                            fe * (3 * size + 1), 2 * size * costs["mul"]))
        del x, y, c
    rows.append(row_of(muls))

    rows.append(measure("fr_colsum", f"(8,{w},{n})", lambda: kf.colsum(mat),
                        lambda: kf.colsum_plain(mat), fe * w * (n + 1),
                        w * n * costs["add"]))
    del mat
    return rows


@functools.lru_cache(maxsize=4)
def bench_inputs(log_height: int, hasher: str = "poseidon2", workload: str = "perm"):
    """bench.py's workload (``BENCH_HASHER`` = ``hasher``, ``BENCH_WORKLOAD``
    = ``workload``): a 3x3 permutation trace or a 3-column lookup into one
    table, seed 7, and the public challenges drawn from
    random.Random(0xBE7C4).  Cached: the 2^19-row lookup trace takes
    seconds of host Python to generate."""
    import random

    from linea_stark_tpu_torch.config import FriConfig, StarkConfig
    from linea_stark_tpu_torch.field.constants import R_MOD
    from linea_stark_tpu_torch.trace.synthetic import gen_lookup_trace, gen_permutation_trace

    rng = random.Random(0xBE7C4)
    alpha, delta = rng.randrange(R_MOD), rng.randrange(R_MOD)
    config = StarkConfig(fri=FriConfig(log_blowup=3, log_final_poly_len=0,
                                       num_queries=33, proof_of_work_bits=0),
                         hasher=hasher)
    if workload == "lookup":
        raw = gen_lookup_trace(3, 1 << log_height, num_b_tables=1, seed=7)
    else:
        raw = gen_permutation_trace(3, 1 << log_height, seed=7)
    return config, raw, alpha, delta


def build_bench_trace(raw, alpha: int, delta: int, device):
    """``build_trace`` of one bench workload's raw trace, as bench.py calls
    it (no self-check)."""
    from linea_stark_tpu_torch.trace.loader import RawLookupTrace
    from linea_stark_tpu_torch.trace.raw_trace import build_trace

    if isinstance(raw, RawLookupTrace):
        return build_trace([], [raw], alpha, delta, check=False, device=device)
    return build_trace([raw], [], alpha, delta, check=False, device=device)


def golden_phase(device, hasher: str, path: str, workload: str = "perm") -> None:
    """Phases 3, 5, 7 and 9: a 2^12-row golden proof, byte for byte."""
    from linea_stark_tpu_torch.challenger import HashChallenger
    from linea_stark_tpu_torch.prover import prove

    config, raw, alpha, delta = bench_inputs(12, hasher, workload)
    t0 = time.perf_counter()
    built = build_bench_trace(raw, alpha, delta, device)
    proof = prove(config, built.air, built.matrix, [alpha, delta], HashChallenger())
    data = proof.to_bytes()
    dt = time.perf_counter() - t0
    with open(path, "rb") as f:
        want = f.read()
    label = f"{hasher} {workload}, LINEA_FUSED={os.environ.get('LINEA_FUSED', '1')}"
    print(f"golden ({label}): 2^12 rows prove {dt:.3f} s, {len(data)} bytes, "
          f"equal {data == want}", flush=True)
    if data != want:
        raise AssertionError(f"golden proof bytes differ ({label})")


def main_path(device, hasher: str, workload: str = "perm", label: str = None) -> dict:
    """Phases 4, 6, 8 and 9: a bench.py workload at 2^19 rows through the
    port; returns the launches of the timed prove.  ``label`` (default: the
    hasher) names the path in the output and in :data:`PATH_KERNELS`."""
    import copy

    import torch

    from linea_stark_tpu_torch import kernels
    from linea_stark_tpu_torch.challenger import HashChallenger
    from linea_stark_tpu_torch.field import oracle
    from linea_stark_tpu_torch.prover import VerificationError, prove, verify
    from linea_stark_tpu_torch.utils import timing

    label = label or hasher
    config, raw, alpha, delta = bench_inputs(19, hasher, workload)
    t0 = time.perf_counter()
    built = build_bench_trace(raw, alpha, delta, device)
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
    print(f"main path ({label}): 2^19 rows trace build {build_s:.3f} s, warm-up "
          f"prove {warm_s:.3f} s, prove {prove_s:.3f} s, verify {verify_s:.3f} s, "
          f"peak memory {peak / 2**30:.3f} GiB, tampered rejected {rejected}, "
          f"proof {len(proof.to_bytes())} bytes", flush=True)
    print(f"launches ({label}): {json.dumps(launches)}", flush=True)
    profile_prove(lambda: prove(config, built.air, built.matrix, [alpha, delta],
                                HashChallenger()), label)
    if not rejected:
        raise AssertionError(f"tampered proof was accepted ({label})")
    idle = [k for k in PATH_KERNELS[label] if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {label} path: {idle}")
    return launches


def eager_phase(device) -> dict:
    """Phase 9: the golden and the lookup main path under LINEA_FUSED=0
    (the variable is restored afterwards); returns the main path's
    launches."""
    old = os.environ.get("LINEA_FUSED")
    os.environ["LINEA_FUSED"] = "0"
    try:
        golden_phase(device, "poseidon2", GOLDEN)
        launches = main_path(device, "poseidon2", "lookup", label="eager")
    finally:
        if old is None:
            del os.environ["LINEA_FUSED"]
        else:
            os.environ["LINEA_FUSED"] = old
    if launches["fr_mul3_scalar"] < 2:
        raise AssertionError("the eager prove launched fr_mul3_scalar "
                             f"{launches['fr_mul3_scalar']} times, not at least twice")
    return launches


def profile_prove(run, label: str) -> None:
    """One prove under ``torch.profiler``: the device's busy share of the
    host's wall time and the device time of the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): a host op's device time
    # repeats that of the kernels it launched
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                    for e in dev[:6])
    print(f"profile ({label}): prove {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%); {top}", flush=True)


def main() -> int:
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    smi = _smi()
    clock_mhz = max_sm_clock_mhz()
    print(f"gpu: {smi}, max SM clock {clock_mhz:.0f} MHz", flush=True)
    device = torch.device("cuda", 0)

    from linea_stark_tpu_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    probe = start_probe_build()
    log = cuda_lib.build(force=True)
    cuda_lib.lib()
    build_s = time.perf_counter() - t0
    costs = finish_probe_build(probe)
    regs = ptxas_summary(log)
    print(f"build: {build_s:.2f} s, {len(regs)} kernels: {' | '.join(regs)}", flush=True)
    print(f"SASS instructions per operation: {json.dumps(costs)}", flush=True)

    rows = check_kernels(device, small=False, costs=costs, clock_mhz=clock_mhz)
    golden_phase(device, "poseidon2", GOLDEN)
    paths = {"poseidon2": main_path(device, "poseidon2")}
    golden_phase(device, "keccak", GOLDEN_KECCAK)
    paths["keccak"] = main_path(device, "keccak")
    golden_phase(device, "poseidon2", GOLDEN_LOOKUP, "lookup")
    paths["lookup"] = main_path(device, "poseidon2", "lookup", label="lookup")
    paths["eager"] = eager_phase(device)
    for row in rows:  # each kernel's launches on the first path that uses it
        name = row["name"]
        users = [p for p in paths if name in PATH_KERNELS[p]]
        if users:
            row["launches"] = paths[users[0]][name]
        else:
            row["launches"] = max(p[name] for p in paths.values())
            row["launches_note"] = "no prove path calls it: only a direct fr_ops.sum_to_ints"
            if row["launches"]:
                raise AssertionError(f"{name} launched on a prove path")
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
