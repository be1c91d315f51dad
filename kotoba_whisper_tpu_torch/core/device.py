"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without a card raises: nothing carries on silently
on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_model_device(model: torch.nn.Module, dev: torch.device) -> None:
    """Raise unless the model's weights already live on `dev` (a 1.5 B
    parameter model is never moved implicitly)."""
    have = next(model.parameters()).device
    if have.type != dev.type:
        raise ValueError(
            f"model weights are on {have}, but the call asks for {dev}; "
            f"move the model with model.to('{dev.type}') first"
        )
