"""Windowed tracing of training steps (counterpart of ``dalm_tpu/core/profiling.py:22-63``).

``Profiler(output_dir, start_step, num_steps)`` records a ``torch.profiler`` trace (host and, on a card, device
activity) of the steps ``[start_step, start_step + num_steps)`` and writes it to ``output_dir`` as a Chrome trace
(``trace_<start>-<stop>.json``) that ``chrome://tracing`` or Perfetto opens. With ``output_dir=None`` it does
nothing. ``annotate(name)`` names a region of host work in the trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class Profiler:
    """Capture a trace of steps [start, start + num)."""

    def __init__(self, output_dir: Optional[str], start_step: int = 10, num_steps: int = 5):
        self.output_dir = output_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.active = False
        self.done = False
        self._prof = None
        self._started_at = None
        self.trace_path: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return self.output_dir is not None

    def maybe_start(self, step: int) -> None:
        if not self.enabled or self.done or self.active or step < self.start_step:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._started_at = step
        self.active = True
        logger.info("profiler trace started at step %d -> %s", step, self.output_dir)

    def maybe_stop(self, step: int) -> None:
        if not self.active or step < self.stop_step:
            return
        self._finish(step)

    def close(self) -> None:
        if self.active:
            self._finish(None)

    def _finish(self, step: Optional[int]) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        end = step if step is not None else "end"
        self.trace_path = os.path.join(self.output_dir, f"trace_{self._started_at}-{end}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.active = False
        self.done = True
        logger.info("profiler trace stopped at step %s -> %s", end, self.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region of host work (shows up in the trace's timeline)."""
    with torch.profiler.record_function(name):
        yield
