"""Where the port's entry points run.

Every entry point takes ``device="cuda"`` by default: the port is built for
the card, and the CPU is for tests, which ask for it with ``device="cpu"``.
A default call on a machine without CUDA raises here and says why; it never
falls back to the CPU.
"""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available: the port's "
            "entry points run on the GPU by default; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
