"""Byte -> field decode matching the reference's trace-value rule: each
32-byte big-endian value is reduced mod r (ark-ff ``from_be_bytes_mod_order``),
as ``linea_stark_tpu/field/codec.py``.

The whole column decodes at once: the bytes regroup into 32-bit words with
numpy, and one Montgomery multiply by R² (valid for any value < 2**256)
reduces mod r and enters Montgomery form together.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fr_ops as fo
from ..device import resolve


def be_bytes_to_words(data: np.ndarray) -> torch.Tensor:
    """(N, 32) uint8 big-endian scalars -> (8, N) raw int32 words (< 2**256)."""
    a = np.ascontiguousarray(data, dtype=np.uint8)
    assert a.ndim == 2 and a.shape[1] == 32
    be = a.view(">u4").astype(np.uint32)  # (N, 8), most significant first
    words = np.ascontiguousarray(be[:, ::-1].T)
    return torch.from_numpy(words.view(np.int32))


def decode_be_bytes_mod_order(data: np.ndarray, device=None) -> torch.Tensor:
    """(N, 32) uint8 big-endian scalars -> (8, N) Montgomery tensor on
    ``device`` (the CUDA card when None)."""
    return fo.to_mont(be_bytes_to_words(data).to(resolve(device)))
