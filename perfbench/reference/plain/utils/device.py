"""Where the port's entry points run: the card unless the caller asks for
another device."""
from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """`device`, or CUDA when it is None; raises when CUDA is asked for and
    there is no card (no fallback to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain torch version")
    return device
