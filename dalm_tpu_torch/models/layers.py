"""Dense layer with optional packed (QLoRA) weight storage (counterpart of
``dalm_tpu/models/layers.py:FlexLinear``, ``:73-145``).

The weight keeps the JAX layout ``(in, out)`` so parameter trees carry
across without a transpose and ``y = x @ kernel + bias`` reads as the
reference does. Three storages, named after the reference's collections:

- ``kernel`` (a parameter): the classic layer;
- ``q`` int8 ``(in, out)`` + ``scale`` f32 ``(1, out)``, or ``w`` bf16
  (buffers, frozen): the packed base, set by :meth:`to_packed`. With
  ``int8_compute`` "fwd" or "all" an int8 base runs through
  ``kernels.int8_matmul`` (K1/K2; "all" also runs dx in int8), otherwise it
  is dequantised inside this layer's matmul;
- ``a (in, r)``, ``b (r, out)`` (parameters, f32): LoRA factors with
  alpha/r folded into ``a``, applied as ``(x @ a) @ b``, set by
  :meth:`add_lora` (the fused runtime);
- ``lora_a (in, r)``, ``lora_b (r, out)`` (parameters, f32) beside a
  ``kernel``, set by :meth:`add_merge_lora` (the merge runtime of the
  reference's ``lora.merge_lora``, ``lora.py:98-121``): each forward forms the
  effective weight ``kernel + (lora_a @ lora_b * scaling).to(kernel.dtype)``
  and autograd carries the weight's gradient back to the two factors.

So ``y = x @ dequant(W) + (x @ a) @ b [+ bias]``. The calibrated-scale
branches of the reference (``a_scale``, ``dy_scale``, ``:84-108``) and its
int4 storages are not ported yet and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from dalm_tpu_torch.kernels.int8_matmul import int8_matmul

INT8_COMPUTE = ("none", "fwd", "all")
UNPORTED_QUANT_LEAVES = ("a_scale", "dy_scale", "q4", "scale4", "nf4", "pcol")


class FlexLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None, int8_compute: str = "none"):
        super().__init__()
        if int8_compute not in INT8_COMPUTE:
            raise ValueError(f"int8_compute must be one of {INT8_COMPUTE}, not {int8_compute!r}")
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.int8_compute = int8_compute
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, dtype=param_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
            if use_bias else None
        )
        for name in ("q", "scale", "w"):
            self.register_buffer(name, None)
        for name in ("a", "b", "lora_a", "lora_b"):
            self.register_parameter(name, None)
        self.merge_scaling = 1.0

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.02) kernel and zero bias, as the JAX layer initialises."""
        if self.kernel is not None:
            _normal_(self.kernel, 0.02, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def to_packed(self, storage: str, device=None) -> None:
        """Drop ``kernel`` for empty frozen buffers: ``storage`` "int8"
        (``q`` + ``scale``) or "bf16" (``w``). The caller fills them."""
        device = device if device is not None else (self.kernel.device if self.kernel is not None else None)
        shape = (self.in_features, self.out_features)
        self.kernel = None
        self.q = self.scale = self.w = None
        if storage == "int8":
            self.q = torch.empty(shape, dtype=torch.int8, device=device)
            self.scale = torch.empty((1, self.out_features), dtype=torch.float32, device=device)
        elif storage == "bf16":
            self.w = torch.empty(shape, dtype=torch.bfloat16, device=device)
        else:
            raise ValueError(f"packed storage must be 'int8' or 'bf16', not {storage!r}")

    def add_lora(self, rank: int, device=None) -> None:
        """Trainable f32 factors ``a (in, rank)`` and ``b (rank, out)``, zero until filled."""
        device = device if device is not None else next(
            t.device for t in (self.kernel, self.q, self.w) if t is not None)
        self.a = nn.Parameter(torch.zeros(self.in_features, rank, dtype=torch.float32, device=device))
        self.b = nn.Parameter(torch.zeros(rank, self.out_features, dtype=torch.float32, device=device))

    def add_merge_lora(self, rank: int, scaling: float, device=None) -> None:
        """Trainable f32 factors ``lora_a (in, rank)`` and ``lora_b (rank, out)``
        (zero until filled) merged into ``kernel`` in every forward, times ``scaling``."""
        if self.kernel is None:
            raise ValueError("the merge runtime needs a dense kernel; a packed base takes add_lora")
        device = device if device is not None else self.kernel.device
        self.lora_a = nn.Parameter(torch.zeros(self.in_features, rank, dtype=torch.float32, device=device))
        self.lora_b = nn.Parameter(torch.zeros(rank, self.out_features, dtype=torch.float32, device=device))
        self.merge_scaling = float(scaling)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.q is not None and self.int8_compute != "none":
            y = int8_matmul(x, self.q, self.scale, self.int8_compute == "all")
        else:
            if self.q is not None:
                kernel = (self.q.float() * self.scale.float()).to(self.dtype)
            elif self.w is not None:
                kernel = self.w.to(self.dtype)
            elif self.lora_a is not None:
                delta = (self.lora_a @ self.lora_b) * self.merge_scaling
                kernel = (self.kernel + delta.to(self.kernel.dtype)).to(self.dtype)
            else:
                kernel = self.kernel.to(self.dtype)
            y = x @ kernel
        if self.a is not None:
            y = y + (x @ self.a.to(self.dtype)) @ self.b.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def _normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """In-place normal(0, std) from an explicit generator. Drawn in f32 on
    the generator's device and cast, so bf16 weights get rounded f32 draws."""
    with torch.no_grad():
        draw = torch.randn(p.shape, generator=generator, device=generator.device, dtype=torch.float32)
        p.copy_((draw * std).to(device=p.device, dtype=p.dtype))
