"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  Without a card
that raises: the port never moves to the CPU on its own.  The CPU is
used only when the caller passes ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the port's plain PyTorch path")
    return dev
