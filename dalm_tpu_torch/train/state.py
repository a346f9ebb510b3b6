"""Minimal train state: the trainable parameters by name, their optimiser
and the micro-step count (counterpart of ``dalm_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from dalm_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]  # insertion order is the optimiser's order
    optimizer: Optimizer
    step: int = 0  # apply_gradients calls (micro-steps)

    @classmethod
    def create(cls, params: Dict[str, torch.nn.Parameter], optimizer: Optimizer) -> "TrainState":
        if [id(p) for p in params.values()] != [id(p) for p in optimizer.params]:
            raise ValueError("the optimiser must hold exactly the state's parameters, in order")
        return cls(params=params, optimizer=optimizer)

    def apply_gradients(self) -> "TrainState":
        """One optimiser (micro-)step from the gradients now on the parameters."""
        self.optimizer.step()
        self.step += 1
        return self

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "params": {k: v.detach() for k, v in self.params.items()},
            "opt_state": self.optimizer.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        if set(state["params"]) != set(self.params):
            raise KeyError("checkpoint parameters do not match the trainable parameters")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(state["params"][k])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
