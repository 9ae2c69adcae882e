"""Loss functions (counterpart of ceres_tpu/loss.py).

The slice carries the interface and `TrivialLoss`. Robust losses inside
the fused evaluation kernel are a later slice: a problem that names one
raises NotImplementedError when it is compiled.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


class LossFunction:
    """rho(s) and its first two derivatives, elementwise over s."""

    def evaluate(self, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
        raise NotImplementedError

    def __call__(self, s):
        return self.evaluate(s)


@dataclasses.dataclass(frozen=True)
class TrivialLoss(LossFunction):
    """rho(s) = s (no robustification)."""

    def evaluate(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)
