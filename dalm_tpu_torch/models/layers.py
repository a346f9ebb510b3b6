"""Dense layer (counterpart of ``dalm_tpu/models/layers.py:FlexLinear``,
plain ``params`` branch ``:119-145``).

The weight keeps the JAX layout ``(in, out)`` so parameter trees carry
across without a transpose and ``y = x @ kernel + bias`` reads as the
reference does. The ``quant`` and ``lora`` storage branches wait for the
training and quantised-serving slices.
"""

from __future__ import annotations

import torch
from torch import nn


class FlexLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, dtype=param_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
            if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.02) kernel and zero bias, as the JAX layer initialises."""
        _normal_(self.kernel, 0.02, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def _normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """In-place normal(0, std) from an explicit generator. Drawn in f32 on
    the generator's device and cast, so bf16 weights get rounded f32 draws."""
    with torch.no_grad():
        draw = torch.randn(p.shape, generator=generator, device=generator.device, dtype=torch.float32)
        p.copy_((draw * std).to(device=p.device, dtype=p.dtype))
