"""linea_stark_tpu_torch — the STARK prover's main path in PyTorch with
hand-written CUDA kernels for Hopper (``sm_90a``).

A port of ``linea_stark_tpu`` (JAX/Pallas on TPU), which stays the
reference: on the same inputs the two produce the same proof bytes.  The
port imports torch, numpy and the standard library only — never JAX and
never the JAX package.

Layer map (bottom-up):
    field/       Fr words: (8, *batch) int32 Montgomery tensors, converters,
                 plain int64 arithmetic; jax-free constants and oracle
    kernels/     CUDA kernel wrappers (K1-K4), their plain versions and
                 launch counters; sources in csrc/
    fr_ops.py    field ops for prover code (CUDA -> kernel, CPU -> plain)
    ntt/         Stockham NTT and coset LDE
    hash/        Poseidon2 (host half copied, device half on K4), hasher,
                 native C engine bindings
    merkle/      single-height MMCS: commit, open, batch verify
    challenger/  Fiat-Shamir transcript (copy)
    fri/         folding
    pcs/         two-adic FRI PCS, native transcript
    air/         gadget constraints over vector / scalar algebras
    trace/       synthetic and CBOR traces, permutation column builder
    prover/      prove / verify, proof container
    utils/       CBOR, span timing, native build helper
"""

__version__ = "0.1.0"
