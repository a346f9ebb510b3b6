"""dalm_tpu_torch: the PyTorch / CUDA (Hopper) port of ``dalm_tpu``.

The JAX package ``dalm_tpu`` is the reference this package is held
against; this package imports nothing of it (nor JAX). Module names
mirror ``dalm_tpu``. Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``; hand-written kernels live under ``csrc/`` and are
built with ``nvcc`` at first use (``kernels/build.py``).
"""

from dalm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
