"""Composite pipelines (counterpart of ``dalm_tpu/pipelines/``)."""

from dalm_tpu_torch.pipelines.reading_comprehension import (
    LLMKwargs,
    SynthKwargs,
    SynthMode,
    pipeline,
)

__all__ = ["LLMKwargs", "SynthKwargs", "SynthMode", "pipeline"]
