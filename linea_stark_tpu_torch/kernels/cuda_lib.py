"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, bound with ``ctypes``.

The library is built at first use from ``linea_stark_tpu_torch/csrc/`` into
``build/linea_stark_tpu_torch/libkernels.so`` for ``sm_90a``, one compiler
process per source running side by side.  Nothing is
built or imported when this module is imported.  A missing compiler or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

from ..utils.build import BUILD_DIR, BuildError, compile_shared, stale

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ["field_ops.cu", "ntt.cu", "poseidon2.cu", "keccak.cu"]
HEADERS = ["fr.cuh"]
TARGET = os.path.join(BUILD_DIR, "libkernels.so")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LIB = None
BUILD_LOG = ""

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "fr_binop": [_I, _P, _LL, _P, _LL, _LL, _LL, _P, _LL, _P],
    "fr_wsum_partials": [_P, _LL, _LL, _I, _P, _LL, _LL, _P, _I, _P],
    "fr_sum_finish": [_P, _I, _I, _P, _P],
    "fr_mul3_scalar": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P],
    "fr_colsum_partials": [_P, _LL, _LL, _I, _LL, _P, _I, _P],
    "ntt_stage": [_I, _P, _P, _LL, _LL, _LL, _P, _LL, _P],
    "p2_set_constants": [_P, _I],
    "p2_permute": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _LL, _I, _I, _P],
    "p2_permute2": [_P, _LL, _P, _LL, _P, _P, _P, _LL, _I, _I, _P],
    "p2_merkle_level": [_P, _LL, _P, _LL, _I, _I, _P],
    "kc_hash": [_P, _P, _P, _I, _P, _LL, _P],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(force: bool = False) -> str:
    """Compile the kernels if any source is newer than the library (always
    with ``force``): one ``nvcc -c`` per source, all started together, then
    one link.  Returns the compilers' output (register and spill counts from
    ``-Xptxas -v``)."""
    global BUILD_LOG
    sources = [os.path.join(CSRC, s) for s in SOURCES]
    deps = [os.path.join(CSRC, h) for h in HEADERS]
    if not force and not stale(TARGET, sources + deps):
        BUILD_LOG = ""
        return BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    jobs = []
    for src in sources:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", CSRC, "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"(exit {proc.returncode}): {' '.join(cmd)}\n{out}")
    objs = [obj for _cmd, obj, _proc in jobs]
    try:
        if failed:
            raise BuildError("build of libkernels.so failed " + "\n".join(failed))
        logs.append(compile_shared([nvcc, ARCH, "-shared"], objs, TARGET, force=True))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    BUILD_LOG = "".join(logs)
    return BUILD_LOG


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        build()
        handle = ctypes.CDLL(TARGET)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def check_field(t: torch.Tensor, name: str, rank: int = 2) -> None:
    """A CUDA int32 (8, ...) tensor whose innermost axis is contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != rank or t.shape[0] != 8:
        raise ValueError(f"{name}: expected rank-{rank} (8, ...), got {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: innermost axis must be contiguous")
