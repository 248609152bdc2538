"""The port's one default-device rule.

Entry points that build tensors from host data (``trace.build_trace``,
``field.codec.decode_be_bytes_mod_order``) run on the CUDA card unless the
caller names a device.  Without a card they raise: nothing falls back to the
CPU's plain versions unasked.  Pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises when no CUDA device exists."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            'pass device="cpu" to run the plain versions on the CPU'
        )
    return torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as given, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)
