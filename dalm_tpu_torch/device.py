"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a card raises; nothing
    quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # the form tensors report, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
