"""Machine-independent step counts for dual-side sparse GEMM."""
from __future__ import annotations

from typing import NamedTuple

import torch


class StepCounts(NamedTuple):
    dense: torch.Tensor   # steps the dense schedule would take
    sparse: torch.Tensor  # steps after dual-side skipping
    tiles_skipped: torch.Tensor  # level-2 whole-tile skips
