"""Top-k with a stable tie order (counterpart of ``multimodal_colpali_tpu/ops/topk.py``).

``torch.topk`` promises no order among equal values, so the ranking is a
stable sort on ``-scores``: descending score, then ascending index, the
order of the JAX package's ``topk_with_stable_ties`` (topk.py:30-49).
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_with_stable_ties(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; ties broken toward the lower index.

    Returns (values ``[..., k]`` float32, indices ``[..., k]`` int32),
    ordered by descending value then ascending index.
    """
    s = scores.float()
    order = torch.argsort(-s, dim=-1, stable=True)[..., :k]
    return torch.gather(s, -1, order), order.to(torch.int32)
