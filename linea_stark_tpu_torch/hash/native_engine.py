"""ctypes bindings for the native host engine (``native/fasthash.c``).

Jax-free copy of ``linea_stark_tpu/hash/native_engine.py``: batch Fr
arithmetic, Poseidon2 and Keccak-256 sweeps on the host CPU, used by the FRI
host tail and the verifier's Merkle-path sweeps.  Unlike the reference, this
copy builds ``native/fasthash.c`` itself, into ``build/linea_stark_tpu_torch/``
with a constants header generated from this package's constants, and a
failed build or load raises: it never turns the engine off silently.
``kc_hash_columns`` also refuses rows wider than the C sweep reads.

Value layout at the ABI: ``(n, 4)`` uint64 little-endian limb rows holding
canonical (non-Montgomery) residues mod r; an ``(8, n)`` int32 tensor's
transpose viewed as uint64 is exactly such a row set (``field.fr.to_u64_rows``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from ..field.constants import MONT_R2, R_MOD
from ..utils.build import BUILD_DIR, REPO_ROOT, BuildError, compile_shared, stale
from .poseidon2 import Poseidon2Params

_LIB = None
_U64P = ctypes.POINTER(ctypes.c_uint64)
_U32P = ctypes.POINTER(ctypes.c_uint32)


_FASTHASH_C = os.path.join(REPO_ROOT, "native", "fasthash.c")
_HEADER = os.path.join(BUILD_DIR, "fastcodec_constants.h")
_TARGET = os.path.join(BUILD_DIR, "libfasthash.so")


def _constants_header() -> str:
    """The constants header ``native/fasthash.c`` includes, generated from
    this package's own field constants."""
    n0 = pow(-R_MOD, -1, 1 << 64)

    def limbs64(x):
        return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]

    lines = ["/* generated by linea_stark_tpu_torch/hash/native_engine.py */"]
    for i, v in enumerate(limbs64(R_MOD)):
        lines.append(f"#define R64_{i} UINT64_C({v:#x})")
    for i, v in enumerate(limbs64(MONT_R2)):
        lines.append(f"#define R2_{i} UINT64_C({v:#x})")
    lines.append(f"#define N0INV64 UINT64_C({n0:#x})")
    return "\n".join(lines) + "\n"


_OMP_PROBE = (
    "int f(int n) {\n  int s = 0;\n#pragma omp parallel for reduction(+:s)\n"
    "  for (int i = 0; i < n; i++) s += i;\n  return s;\n}\n"
)


def openmp_cc() -> str:
    """The first of ``$CC``, ``cc`` and ``gcc`` that compiles and links an
    OpenMP shared object.

    A ``$CC`` can name a compiler whose OpenMP runtime is not installed
    (``-fopenmp`` then fails to link for want of ``libgomp.spec``) while the
    system's ``cc`` has it.  Raises :class:`BuildError` with every
    candidate's error when none links."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, f"omp_probe.{os.getpid()}.c")
    out = f"{src[:-2]}.so"
    with open(src, "w") as f:
        f.write(_OMP_PROBE)
    errors = []
    try:
        for cc in dict.fromkeys(c for c in (os.environ.get("CC"), "cc", "gcc") if c):
            try:
                proc = subprocess.run(
                    [cc, "-shared", "-fPIC", "-fopenmp", "-o", out, src],
                    capture_output=True, text=True,
                )
            except OSError as e:
                errors.append(f"{cc}: {e}")
                continue
            if proc.returncode == 0:
                return cc
            errors.append(f"{cc}: {proc.stdout}{proc.stderr}".strip())
    finally:
        for p in (src, out):
            if os.path.exists(p):
                os.remove(p)
    raise BuildError("no C compiler links OpenMP code:\n" + "\n".join(errors))


def build() -> str:
    """Compile ``native/fasthash.c`` into the package's build directory
    (stale check and atomic rename in :mod:`..utils.build`)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    text = _constants_header()
    current = None
    if os.path.exists(_HEADER):
        with open(_HEADER) as f:
            current = f.read()
    if current != text:
        tmp = f"{_HEADER}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, _HEADER)
    if stale(_TARGET, [_FASTHASH_C, _HEADER]):
        compile_shared(
            [openmp_cc(), "-O3", "-shared", "-fPIC", "-fopenmp", "-I", BUILD_DIR],
            [_FASTHASH_C], _TARGET, deps=[_HEADER],
        )
    return _TARGET


def _load():
    """Build (if stale) and load the engine; raises when either fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    for name, argtypes in (
        ("fr_mul_batch", [_U64P, _U64P, _U64P, ctypes.c_size_t]),
        ("fr_add_batch", [_U64P, _U64P, _U64P, ctypes.c_size_t]),
        ("fr_sub_batch", [_U64P, _U64P, _U64P, ctypes.c_size_t]),
        ("fr_powers", [_U64P, _U64P, ctypes.c_size_t]),
        ("fr_from_mont_batch", [_U64P, _U64P, ctypes.c_size_t]),
        ("fr_to_mont_batch", [_U64P, _U64P, ctypes.c_size_t]),
        ("fr_inv_batch", [_U64P, _U64P, ctypes.c_size_t]),
        ("fr_fold", [_U64P, ctypes.c_size_t, _U64P, _U64P, _U64P, _U64P]),
        ("p2_permute_batch",
         [_U64P, ctypes.c_int, ctypes.c_int, _U64P, _U64P, _U64P,
          ctypes.c_size_t]),
        ("p2_compress_batch",
         [_U64P, ctypes.c_int, ctypes.c_int, _U64P, _U64P, _U64P,
          ctypes.c_size_t]),
        ("p2_hash_columns",
         [_U64P, ctypes.c_int, ctypes.c_int, _U64P, ctypes.c_size_t,
          ctypes.c_size_t, _U64P]),
        ("p2_tree_levels",
         [_U64P, ctypes.c_int, ctypes.c_int, _U64P, ctypes.c_size_t, _U64P]),
        ("p2_merkle_roots",
         [_U64P, ctypes.c_int, ctypes.c_int, _U64P, _U64P, _U64P, _U32P,
          ctypes.c_size_t, ctypes.c_size_t]),
        ("kc_hash_columns", [_U64P, ctypes.c_size_t, ctypes.c_size_t, _U64P]),
        ("kc_compress_batch", [_U64P, _U64P, _U64P, ctypes.c_size_t]),
        ("kc_tree_levels", [_U64P, ctypes.c_size_t, _U64P]),
        ("kc_merkle_roots",
         [_U64P, _U64P, _U64P, _U32P, ctypes.c_size_t, ctypes.c_size_t]),
    ):
        getattr(lib, name).argtypes = argtypes
    _LIB = lib
    return lib


def available() -> bool:
    """True once the engine is built and loaded; a failed build or load
    raises instead of turning the engine off."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def ints_to_u64(vals) -> np.ndarray:
    """Iterable of canonical ints -> (n, 4) uint64 LE limb rows."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4).copy()


def u64_to_ints(arr: np.ndarray) -> list:
    data = np.ascontiguousarray(arr, dtype=np.uint64).tobytes()
    return [
        int.from_bytes(data[32 * i : 32 * i + 32], "little")
        for i in range(len(data) // 32)
    ]


def obj_to_u64(arr: np.ndarray) -> np.ndarray:
    return ints_to_u64(arr.tolist())


def u64_to_obj(arr: np.ndarray) -> np.ndarray:
    return np.array(u64_to_ints(arr), dtype=object)


@functools.lru_cache(maxsize=8)
def _consts(params: Poseidon2Params) -> np.ndarray:
    """Canonical (rf+rp, 3, 4) u64 schedule in the kernel's row order."""
    rows = []
    for rc in params.external_constants(0):
        rows.append(list(rc))
    for c in params.internal_constants():
        rows.append([c, 0, 0])
    for rc in params.external_constants(1):
        rows.append(list(rc))
    flat = [c for row in rows for c in row]
    return ints_to_u64(flat)


# ---------------------------------------------------------------------------
# Field batch ops ((n, 4) u64 canonical in/out)
# ---------------------------------------------------------------------------

def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty_like(a)
    lib.fr_mul_batch(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty_like(a)
    lib.fr_add_batch(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty_like(a)
    lib.fr_sub_batch(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def powers(base: int, count: int) -> np.ndarray:
    lib = _load()
    b = ints_to_u64([base % R_MOD])
    out = np.empty((count, 4), dtype=np.uint64)
    lib.fr_powers(_ptr(b), _ptr(out), count)
    return out


def from_mont(a: np.ndarray) -> np.ndarray:
    """Montgomery (n, 4) rows (e.g. ``field.fr.to_u64_rows`` of a tensor)
    -> canonical rows."""
    lib = _load()
    out = np.empty_like(a)
    lib.fr_from_mont_batch(_ptr(np.ascontiguousarray(a)), _ptr(out), a.shape[0])
    return out


def to_mont(a: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty_like(a)
    lib.fr_to_mont_batch(_ptr(np.ascontiguousarray(a)), _ptr(out), a.shape[0])
    return out


def inv(a: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty_like(a)
    lib.fr_inv_batch(_ptr(a), _ptr(out), a.shape[0])
    return out


def fold(f: np.ndarray, beta: int, shift: int, omega: int) -> np.ndarray:
    """One arity-2 FRI fold of a canonical (n, 4) codeword, natural order."""
    lib = _load()
    n = f.shape[0]
    half = n // 2
    inv2 = pow(2, R_MOD - 2, R_MOD)
    # inv2x[i] = 1/(2·shift·omega^i) = inv2·inv_shift·inv_omega^i
    inv_shift = pow(shift, R_MOD - 2, R_MOD)
    inv_omega = pow(omega, R_MOD - 2, R_MOD)
    t = powers(inv_omega, half)
    c = ints_to_u64([(inv2 * inv_shift) % R_MOD])
    inv2x = mul(t, np.broadcast_to(c, t.shape).copy())
    out = np.empty((half, 4), dtype=np.uint64)
    lib.fr_fold(
        _ptr(np.ascontiguousarray(f)), n,
        _ptr(ints_to_u64([beta % R_MOD])),
        _ptr(ints_to_u64([inv2])),
        _ptr(inv2x), _ptr(out),
    )
    return out


# ---------------------------------------------------------------------------
# Poseidon2 sweeps
# ---------------------------------------------------------------------------

def permute(s0, s1, s2, params: Poseidon2Params):
    lib = _load()
    c = _consts(params)
    a = np.ascontiguousarray(s0).copy()
    b = np.ascontiguousarray(s1).copy()
    d = np.ascontiguousarray(s2).copy()
    lib.p2_permute_batch(
        _ptr(c), params.rounds_f, params.rounds_p,
        _ptr(a), _ptr(b), _ptr(d), a.shape[0],
    )
    return a, b, d


def compress(a: np.ndarray, b: np.ndarray, params: Poseidon2Params) -> np.ndarray:
    lib = _load()
    c = _consts(params)
    out = np.empty_like(a)
    lib.p2_compress_batch(
        _ptr(c), params.rounds_f, params.rounds_p,
        _ptr(np.ascontiguousarray(a)), _ptr(np.ascontiguousarray(b)),
        _ptr(out), a.shape[0],
    )
    return out


def hash_columns(cols: np.ndarray, params: Poseidon2Params) -> np.ndarray:
    """cols: (w, n, 4) canonical -> (n, 4) sponge digests."""
    lib = _load()
    c = _consts(params)
    w, n = cols.shape[0], cols.shape[1]
    out = np.empty((n, 4), dtype=np.uint64)
    lib.p2_hash_columns(
        _ptr(c), params.rounds_f, params.rounds_p,
        _ptr(np.ascontiguousarray(cols)), w, n, _ptr(out),
    )
    return out


def tree_levels(leaves: np.ndarray, params: Poseidon2Params) -> list:
    """All digest levels above (n, 4) leaves -> [(n/2, 4), ..., (1, 4)]."""
    lib = _load()
    c = _consts(params)
    n = leaves.shape[0]
    packed = np.empty((n - 1, 4), dtype=np.uint64)
    lib.p2_tree_levels(
        _ptr(c), params.rounds_f, params.rounds_p,
        _ptr(np.ascontiguousarray(leaves)), n, _ptr(packed),
    )
    return _levels(packed, n)


def _levels(packed: np.ndarray, n: int) -> list:
    """Split a packed (n - 1, 4) level buffer into [(n/2, 4), ..., (1, 4)]."""
    levels = []
    off, size = 0, n
    while size > 1:
        size //= 2
        levels.append(packed[off : off + size])
        off += size
    return levels


# ---------------------------------------------------------------------------
# Keccak-256 sweeps (field-element digests; hash/keccak.py semantics)
# ---------------------------------------------------------------------------

# native/fasthash.c kc_hash_columns gathers each row into a 64-value scratch
# buffer and drops any column past it without a word.
KC_MAX_COLUMNS = 64


def kc_hash_columns(cols: np.ndarray) -> np.ndarray:
    """cols: (w, n, 4) canonical -> (n, 4) keccak field digests; raises for
    w > 64, which the C sweep would silently truncate."""
    lib = _load()
    w, n = cols.shape[0], cols.shape[1]
    if w > KC_MAX_COLUMNS:
        raise ValueError(
            f"kc_hash_columns hashes at most {KC_MAX_COLUMNS} columns, got {w}")
    out = np.empty((n, 4), dtype=np.uint64)
    lib.kc_hash_columns(_ptr(np.ascontiguousarray(cols)), w, n, _ptr(out))
    return out


def kc_compress(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty_like(a)
    lib.kc_compress_batch(
        _ptr(np.ascontiguousarray(a)), _ptr(np.ascontiguousarray(b)),
        _ptr(out), a.shape[0],
    )
    return out


def kc_tree_levels(leaves: np.ndarray) -> list:
    """All digest levels above (n, 4) leaves -> [(n/2, 4), ..., (1, 4)]."""
    lib = _load()
    n = leaves.shape[0]
    packed = np.empty((n - 1, 4), dtype=np.uint64)
    lib.kc_tree_levels(_ptr(np.ascontiguousarray(leaves)), n, _ptr(packed))
    return _levels(packed, n)


def kc_merkle_roots(
    digests: np.ndarray,
    sibs: np.ndarray,
    parity_mask: np.ndarray,
    lens: np.ndarray,
) -> np.ndarray:
    """Keccak twin of :func:`merkle_roots` (same ABI minus constants)."""
    lib = _load()
    d = np.ascontiguousarray(digests).copy()
    q, max_len = sibs.shape[0], sibs.shape[1]
    lib.kc_merkle_roots(
        _ptr(d), _ptr(np.ascontiguousarray(sibs)),
        _ptr(np.ascontiguousarray(parity_mask)),
        np.ascontiguousarray(lens, dtype=np.uint32).ctypes.data_as(_U32P),
        max_len, q,
    )
    return d


def merkle_roots(
    digests: np.ndarray,
    sibs: np.ndarray,
    parity_mask: np.ndarray,
    lens: np.ndarray,
    params: Poseidon2Params,
) -> np.ndarray:
    """Walk q authentication paths at once.

    digests: (q, 4) leaf digests; sibs: (q, max_len, 4); parity_mask:
    (q, 4) uint64 bitmask (bit l set = node is right child at level l);
    lens: (q,) uint32 path lengths.  Returns (q, 4) computed roots.
    """
    lib = _load()
    c = _consts(params)
    d = np.ascontiguousarray(digests).copy()
    q, max_len = sibs.shape[0], sibs.shape[1]
    lib.p2_merkle_roots(
        _ptr(c), params.rounds_f, params.rounds_p,
        _ptr(d), _ptr(np.ascontiguousarray(sibs)),
        _ptr(np.ascontiguousarray(parity_mask)),
        np.ascontiguousarray(lens, dtype=np.uint32).ctypes.data_as(_U32P),
        max_len, q,
    )
    return d
