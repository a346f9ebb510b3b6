"""Eval results (counterpart of ``dalm_tpu/eval/results.py:8-17``).

A dataclass with the same fields, order and defaults as the reference's
pydantic model. ``model_dump_json`` writes the compact JSON pydantic writes
for these values: fields in order, ``null`` for ``None`` (and for a value
that is not finite), floats in their shortest round-trip digits, in decimal
notation for decimal exponents -5 to 15 and as ``1.5e-7`` outside it.
``model_copy(update=...)`` returns a copy with fields replaced.
"""

from __future__ import annotations

import dataclasses
import math
from decimal import Decimal
from typing import Optional


def _json_float(v: float) -> str:
    v = float(v)
    if not math.isfinite(v):
        return "null"
    sign = "-" if math.copysign(1.0, v) < 0 else ""
    if v == 0:
        return sign + "0.0"
    t = Decimal(repr(abs(v))).normalize().as_tuple()
    digits, k = "".join(map(str, t.digits)), t.exponent
    kk = len(digits) + k  # 10^(kk-1) <= |v| < 10^kk
    if 0 <= k and kk <= 16:
        s = digits + "0" * k + ".0"
    elif 0 < kk <= 16:
        s = f"{digits[:kk]}.{digits[kk:]}"
    elif -5 < kk <= 0:
        s = "0." + "0" * -kk + digits
    else:
        s = digits[0] + (f".{digits[1:]}" if len(digits) > 1 else "") + f"e{kk - 1}"
    return sign + s


@dataclasses.dataclass
class EvalResults:
    total_examples: int
    recall: float
    precision: float
    hit_rate: float
    exact_match: Optional[float] = None
    # mean reciprocal rank of the gold passage (0 when missed)
    mrr: Optional[float] = None

    def model_dump_json(self) -> str:
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                text = "null"
            elif f.name == "total_examples":
                text = str(int(v))
            else:
                text = _json_float(v)
            parts.append(f'"{f.name}":{text}')
        return "{" + ",".join(parts) + "}"

    def model_copy(self, update: Optional[dict] = None) -> "EvalResults":
        return dataclasses.replace(self, **(update or {}))
