"""K5 ``kc_hash`` (``csrc/keccak.cu``): Keccak-256 field digests of rows.

Replaces ``linea_stark_tpu/hash/hasher.py`` ``_keccak_fixed_kernel_call``
(whose body is ``hash/keccak.py`` ``keccak256_fixed_vec``) together with the
conversions around it (``_mont_cols_to_words``, ``_digest_words_to_field_mont``):
one thread per row converts the row's Montgomery values to canonical
big-endian bytes, runs the sponge and brings the digest back into Montgomery
form, so no message-word tensor ever reaches device memory.  Bound: integer
issue (the source says why).

One entry, :func:`hash_columns`, takes W strided (8, N) column views and
serves every mode: a leaf hash (the columns of an (8, W, N) matrix), a
Merkle level (the two views ``d[:, 0::2]``, ``d[:, 1::2]``) and a
compression (two separate tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hash import hasher as hs
from ..hash.keccak import keccak256_fixed_vec
from . import LAUNCHES
from . import cuda_lib as cl

MAX_COLUMNS = 64  # the kernel's column table (csrc/keccak.cu kMaxCols)


def hash_columns_plain(cols) -> torch.Tensor:
    """The plain composition: message words, Keccak-256, field digest."""
    return hs._digest_words_to_field_mont(keccak256_fixed_vec(hs._mont_cols_to_words(cols)))


def hash_columns(cols) -> torch.Tensor:
    """Keccak-256 field digest of each row of W (8, N) Montgomery columns ->
    (8, N) Montgomery digests."""
    cols = list(cols)
    if not cols:
        raise ValueError("kc_hash needs at least one column")
    if cols[0].device.type == "cpu":
        return hash_columns_plain(cols)
    if len(cols) > MAX_COLUMNS:
        raise ValueError(f"kc_hash takes at most {MAX_COLUMNS} columns, got {len(cols)}")
    n = cols[0].shape[1]
    dev = cols[0].device
    for c, t in enumerate(cols):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"column {c}: expected a tensor on {dev}, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"column {c}: expected int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != 8 or t.shape[1] != n:
            raise ValueError(f"column {c}: expected (8, {n}), got {tuple(t.shape)}")
    ptrs = np.array([t.data_ptr() for t in cols], dtype=np.uint64)
    limb = np.array([t.stride(0) for t in cols], dtype=np.int64)
    elem = np.array([t.stride(1) for t in cols], dtype=np.int64)
    out = torch.empty((8, n), dtype=torch.int32, device=dev)
    rc = cl.lib().kc_hash(
        ptrs.ctypes.data, limb.ctypes.data, elem.ctypes.data, len(cols),
        out.data_ptr(), n, cl.stream_handle(out),
    )
    cl.check(rc, "kc_hash")
    LAUNCHES["kc_hash"] += 1
    return out
