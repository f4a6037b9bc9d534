"""Attention over independent windows (counterpart of
``multimodal_colpali_tpu/ops/window_attention.py``).

ColFlor's DaViT attends within 12 x 12 windows: windows and heads are
flattened into one leading axis, ``[N, S, D]`` (N = batch x windows x heads,
S = window tokens, D = head_dim), and every row block is an independent,
unmasked attention problem.

- :func:`window_attention_reference` - the plain PyTorch version, the math
  of ``window_attention_xla`` (window_attention.py:33-42): float32 logits
  times ``scale``, a float32 softmax, the probabilities rounded to v's dtype,
  P.V summed in float32, the result in q's dtype.
- :func:`window_attention_cuda` - the hand-written CUDA kernel K6
  (``csrc/window_attention.cu``) that replaces the TPU kernel ``_kernel``
  (window_attention.py:45-59, ``pl.pallas_call`` at :79); :func:`kernel_path`
  names the kernel a launch takes, from dtype and shape alone.
- :func:`window_attention` - the dispatcher: a CPU tensor takes the plain
  version, a CUDA tensor the kernel, with no fallback between them.
"""

from __future__ import annotations

import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               scale: float) -> torch.Tensor:
    """Batched attention over ``[N, S, D]`` windows with a float32 softmax."""
    logits = torch.einsum("nsd,ntd->nst", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("nst,ntd->nsd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# The ring kernel's largest window: every ColFlor DaViT stage (12 x 12, head_dim 32).
RING_S, RING_D = 144, 32


def kernel_path(dtype: torch.dtype, s: int, d: int) -> str:
    """The kernel ``window_attention_launch`` runs for ``[N, s, d]`` windows
    of ``dtype``: ``"ring"`` (bf16, s <= 144, d <= 32: persistent blocks over a
    ring of TMA-fed stages), ``"wmma"`` (other bf16 windows; the launch
    refuses s > 512 or d > 128) or ``"cuda_core"`` (float32)."""
    if dtype == torch.float32:
        return "cuda_core"
    return "ring" if s <= RING_S and d <= RING_D else "wmma"


def ring_grid() -> int:
    """The ring kernel's persistent grid on the current device: the blocks
    that fit the card at once (SMs x resident blocks)."""
    lib = _build.load("window_attention")
    blocks = lib.window_attention_grid()
    _build.check(lib, max(0, -blocks), "window_attention_grid")
    return blocks


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            scale: float, lib=None) -> None:
    """One launch on checked, contiguous tensors; ``lib`` is a probe build
    of ``csrc/window_attention.cu`` (``_build.build_variant``) or None."""
    lib = lib or _build.load("window_attention")
    n, s, d = q.shape
    code = lib.window_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, s, d, float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, f"window_attention_launch (S={s}, D={d})")


def window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: float) -> torch.Tensor:
    """K6 on the card: q, k and v share one ``[N, S, D]`` shape and one dtype
    (float32 or bf16). A window that does not fit in shared memory raises.
    Adds one to ``window_attention_cuda.launches`` per launch, and to
    ``.ring_launches``, ``.wmma_launches`` or ``.cuda_core_launches`` by
    :func:`kernel_path`."""
    refuse_grad("window_attention_cuda", q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("window_attention_cuda needs q, k, v on one CUDA device")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [N, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    _, s, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out, scale)
    window_attention_cuda.launches += 1
    path = f"{kernel_path(q.dtype, s, d)}_launches"
    setattr(window_attention_cuda, path, getattr(window_attention_cuda, path) + 1)
    return out


window_attention_cuda.launches = 0
window_attention_cuda.ring_launches = 0
window_attention_cuda.wmma_launches = 0
window_attention_cuda.cuda_core_launches = 0


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """Attention over independent ``[N, S, D]`` windows: K6 for a CUDA tensor,
    the plain version for a CPU one."""
    if q.device.type == "cuda":
        return window_attention_cuda(q, k, v, scale=scale)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, scale=scale)
    raise ValueError(f"window_attention: unsupported device {q.device}")
