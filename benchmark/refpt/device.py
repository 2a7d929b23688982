# Frozen copy of fountain_tpu_torch/device.py (commit 6354002): the benchmark's plain reference; edit never.
"""Device selection for the port's entry points (no silent CPU fallback)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``.

    Raises when a CUDA device is asked for (explicitly or by default) and
    no card is present: callers that want the CPU say ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fountain_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
