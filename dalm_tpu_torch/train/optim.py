"""Optimiser + learning-rate schedule factory (counterpart of
``dalm_tpu/train/optim.py``), written out so that an update equals the
reference's optax chain number for number:

- schedules by HF ``get_scheduler`` name: a linear warm-up from 0 joined at
  ``num_warmup_steps`` to a linear / cosine / polynomial(power 1) decay over
  the remaining steps, or to a constant; ``constant`` has no warm-up. The
  schedule is read at the count of optimiser steps already taken, so with a
  warm-up the very first update has rate 0;
- Adam (``weight_decay == 0``) or AdamW (decay added to the Adam direction
  before the rate is applied), bias-corrected, ``eps`` outside the root;
- gradient accumulation as ``optax.MultiSteps``: a running mean of the
  micro-step gradients, one optimiser step every ``k`` micro-steps.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

Schedule = Callable[[int], float]


def make_lr_schedule(name: str, learning_rate: float, num_warmup_steps: int, total_steps: int) -> Schedule:
    name = name.replace("-", "_")
    decay_steps = max(total_steps - num_warmup_steps, 1)
    warm_steps = max(num_warmup_steps, 1)

    def warmup(count: int) -> float:
        return learning_rate * min(max(count / warm_steps, 0.0), 1.0)

    if name in ("linear", "polynomial"):
        def decay(count: int) -> float:
            return learning_rate * (1.0 - min(max(count / decay_steps, 0.0), 1.0))
    elif name in ("cosine", "cosine_with_restarts"):
        def decay(count: int) -> float:
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    elif name in ("constant", "constant_with_warmup"):
        def decay(count: int) -> float:
            return learning_rate
    else:
        raise ValueError(f"unknown lr scheduler {name!r}")
    if name == "constant":
        return decay
    return lambda count: warmup(count) if count < num_warmup_steps else decay(count - num_warmup_steps)


class Optimizer:
    """Adam / AdamW over a fixed list of parameters, with optional gradient
    accumulation. ``step()`` consumes ``p.grad`` (a missing gradient counts
    as zero) and clears it; it returns True when parameters were updated."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 gradient_accumulation_steps: int = 1):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay if weight_decay and weight_decay > 0 else 0.0
        self.every = max(int(gradient_accumulation_steps), 1)
        self.count = 0       # optimiser steps taken
        self.mini_step = 0   # micro-steps into the current accumulation
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params] if self.every > 1 else None

    @torch.no_grad()
    def step(self) -> bool:
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                 for p in self.params]
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.every:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        lr = self.schedule(self.count)
        t = self.count + 1
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p.float()
            p.add_((-lr * update).to(p.dtype))
        self.count = t
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, name), state[name]
            if mine is None:
                continue
            for dst, src in zip(mine, theirs):
                dst.copy_(src)


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
                   lr_scheduler_type: str = "linear", num_warmup_steps: int = 0, total_steps: int = 1000,
                   weight_decay: float = 0.0, gradient_accumulation_steps: int = 1,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    schedule = make_lr_schedule(lr_scheduler_type, learning_rate, num_warmup_steps, total_steps)
    return Optimizer(params, schedule, b1, b2, eps, weight_decay, gradient_accumulation_steps)
