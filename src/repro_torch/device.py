"""Device resolution shared by every entry point that creates tensors."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises for CUDA without a card.

    The port runs on the card unless the caller asks for the CPU: there is
    no silent fallback, so ``"cuda"`` on a host without one is an error.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
