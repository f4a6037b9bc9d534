"""Autograd at the kernel wrappers.

A CUDA kernel launched through ctypes writes into a tensor that autograd
knows nothing of: its output has no ``grad_fn``, so a loss behind it would
silently get no gradient through it. K2 has a backward
(``ops/attention._FusedAttention``); every other wrapper that takes a
floating-point input calls :func:`refuse_grad` first and raises instead of
cutting the graph (K3 takes uint8 pixels, which cannot require grad).
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and any of
    ``tensors`` (None and non-tensors are skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward: call it under torch.no_grad() or on tensors "
            "that do not require grad")
