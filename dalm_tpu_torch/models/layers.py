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
- ``q4`` uint8 ``(in/2, out)`` + ``scale4`` f32 ``(in/group, out)`` (buffers,
  frozen; the 4-bit serving storages of ``models/quant.py``), with a 0-d
  marker buffer ``nf4`` (NormalFloat4 codebook) or ``pcol`` (one scale per
  column, ``scale4 (1, out)``) as the reference's ``quant`` tree has it: runs
  through ``kernels.int4_matmul`` (K5); ``int8_compute`` does not apply;
- ``a (in, r)``, ``b (r, out)`` (parameters, f32): LoRA factors with
  alpha/r folded into ``a``, applied as ``(x @ a) @ b``, set by
  :meth:`add_lora` (the fused runtime);
- ``lora_a (in, r)``, ``lora_b (r, out)`` (parameters, f32) beside a
  ``kernel``, set by :meth:`add_merge_lora` (the merge runtime of the
  reference's ``lora.merge_lora``, ``lora.py:98-121``): each forward forms the
  effective weight ``kernel + (lora_a @ lora_b * scaling).to(kernel.dtype)``
  and autograd carries the weight's gradient back to the two factors.

So ``y = x @ dequant(W) + (x @ a) @ b [+ bias]``. The calibrated-scale
branches of the reference (``a_scale``, ``dy_scale``, ``:84-108``) are not
ported yet and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from dalm_tpu_torch.kernels.int4_matmul import int4_matmul
from dalm_tpu_torch.kernels.int8_matmul import int8_matmul
from dalm_tpu_torch.models.quant import _int4_group

INT8_COMPUTE = ("none", "fwd", "all")
UNPORTED_QUANT_LEAVES = ("a_scale", "dy_scale")
STORAGES = ("int8", "bf16", "int4", "nf4", "int4pc")
PACKED_LEAVES = ("q", "scale", "w", "q4", "scale4", "nf4", "pcol")


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
        for name in PACKED_LEAVES:
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

    def to_packed(self, storage: str, device=None, group: int | None = None) -> None:
        """Drop ``kernel`` for empty frozen buffers of a storage in ``STORAGES``:
        "int8" (``q`` + ``scale``), "bf16" (``w``), or the 4-bit "int4", "nf4"
        and "int4pc" (``q4`` + ``scale4`` + marker; ``group`` defaults to what
        the quantiser picks for this width). The caller fills them."""
        if storage not in STORAGES:
            raise ValueError(f"packed storage must be one of {STORAGES}, not {storage!r}")
        device = device if device is not None else (self.kernel.device if self.kernel is not None else None)
        n_in, n_out = self.in_features, self.out_features
        self.kernel = None
        for name in PACKED_LEAVES:
            setattr(self, name, None)
        if storage == "int8":
            self.q = torch.empty((n_in, n_out), dtype=torch.int8, device=device)
            self.scale = torch.empty((1, n_out), dtype=torch.float32, device=device)
        elif storage == "bf16":
            self.w = torch.empty((n_in, n_out), dtype=torch.bfloat16, device=device)
        else:
            if n_in % 2:
                raise ValueError(f"4-bit packing needs an even input width, not {n_in}")
            rows = 1 if storage == "int4pc" else n_in // (group or _int4_group(n_in // 2))
            self.q4 = torch.empty((n_in // 2, n_out), dtype=torch.uint8, device=device)
            self.scale4 = torch.empty((rows, n_out), dtype=torch.float32, device=device)
            if storage == "nf4":
                self.nf4 = torch.ones((), dtype=torch.uint8, device=device)
            elif storage == "int4pc":
                self.pcol = torch.ones((), dtype=torch.int8, device=device)

    def add_lora(self, rank: int, device=None) -> None:
        """Trainable f32 factors ``a (in, rank)`` and ``b (rank, out)``, zero until filled."""
        device = device if device is not None else next(
            t.device for t in (self.kernel, self.q, self.w, self.q4) if t is not None)
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
        if self.q4 is not None:
            y = int4_matmul(x, self.q4, self.scale4, self.nf4 is not None, self.pcol is not None)
        elif self.q is not None and self.int8_compute != "none":
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
