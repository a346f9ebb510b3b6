"""Metrics stream and step timers (own copy of ``dalm_tpu/train/metrics.py``):
JSON lines always (with an output directory), and TensorBoard event files
through ``tensorboardX`` when ``report_to`` is "all" or "tensorboard" and the
package imports (else JSON lines only). ``torch.utils.tensorboard`` is not
used: it imports TensorFlow where that is installed."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional


class MetricsLogger:
    """Appends ``{"event": "metrics", "step", "time", ...}`` records (and one
    ``config`` record) to ``{output_dir}/{project_name}_metrics.jsonl``, and each
    number as a scalar to ``{output_dir}/tb/{project_name}`` when TensorBoard is on."""

    def __init__(self, output_dir: Optional[str] = None, project_name: str = "dalm",
                 config: Optional[Mapping[str, Any]] = None, report_to: str = "all", enabled: bool = True):
        self.enabled = enabled and output_dir is not None
        self._jsonl = None
        self._tb = None
        if not self.enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, f"{project_name}_metrics.jsonl"), "a")
        if config:
            self._write({"event": "config", **_jsonable(config)})
        if report_to in ("all", "tensorboard"):
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb", project_name))
            except Exception:
                self._tb = None

    def _write(self, record: dict) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        if not self.enabled:
            return
        record = {"event": "metrics", "step": int(step), "time": time.time()}
        for k, v in metrics.items():
            v = v.item() if hasattr(v, "item") else v
            record[k] = v
            if self._tb is not None and isinstance(v, (int, float)):
                self._tb.add_scalar(k, v, step)
        self._write(record)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _jsonable(d: Mapping[str, Any]) -> dict:
    return {k: v if v is None or isinstance(v, (bool, int, float, str)) else str(v) for k, v in d.items()}


class StepTimer:
    """EMA step-time / throughput meter."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt

    def samples_per_sec(self, batch_size: int) -> float:
        return batch_size / self.avg if self.avg else 0.0


class WindowedThroughput:
    """Throughput meter that never synchronises the device itself: call
    ``mark(completed_steps)`` right after a loss read-back (the
    synchronisation point) and it derives seconds per step from the wall
    time between marks. The first window (warm-up, kernel builds) is left
    out of the average when there is more than one."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._steps0 = 0
        self.windows: list = []  # (steps, seconds)

    def mark(self, completed_steps: int) -> None:
        now = time.perf_counter()
        if self._t0 is not None and completed_steps > self._steps0:
            self.windows.append((completed_steps - self._steps0, now - self._t0))
        self._t0, self._steps0 = now, completed_steps

    @property
    def avg(self) -> Optional[float]:
        w = self.windows[1:] if len(self.windows) > 1 else self.windows
        steps = sum(s for s, _ in w)
        return sum(t for _, t in w) / steps if steps else None

    def samples_per_sec(self, batch_size: int) -> float:
        a = self.avg
        return batch_size / a if a else 0.0
