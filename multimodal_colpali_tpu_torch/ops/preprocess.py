"""Device-side image normalization (counterpart of ``multimodal_colpali_tpu/ops/preprocess.py``).

uint8 NHWC pages go to the card as bytes (a quarter of the float32 traffic)
and are rescaled and normalized there:
``x * (1 / (255 * std_c)) - mean_c / std_c``, stored as bf16.

- :func:`normalize_images_reference` - the plain PyTorch version
  (``(x / 255 - mean) / std`` in float32, rounded to bf16), the JAX
  package's ``normalize_images_reference`` (preprocess.py:70-74).
- :func:`normalize_images_cuda` - the CUDA kernel K3
  (``csrc/normalize.cu``) that replaces the TPU kernel
  ``_normalize_kernel``. It uses one multiply-add where the plain version
  divides, so the two agree to within one bf16 ulp.
- :func:`normalize_images` - the dispatcher: CPU tensors take the plain
  version, CUDA tensors the kernel, with no fallback between them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from multimodal_colpali_tpu_torch import _build


def normalize_images_reference(images_u8: torch.Tensor,
                               mean: Sequence[float] = (0.5, 0.5, 0.5),
                               std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(torch.bfloat16)


def normalize_images_cuda(images_u8: torch.Tensor,
                          mean: Sequence[float] = (0.5, 0.5, 0.5),
                          std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """K3 on the card: uint8 ``[B, H, W, 3]`` -> bf16 ``[B, H, W, 3]``.

    Adds one to ``normalize_images_cuda.launches`` per kernel launch."""
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected [B, H, W, 3], got {tuple(images_u8.shape)}")
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"normalize_images_cuda takes uint8 pixels, got {images_u8.dtype}")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("mean and std need one value per channel")
    if not images_u8.is_cuda:
        raise ValueError("normalize_images_cuda needs a CUDA tensor")
    x = images_u8.contiguous()
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel() == 0:
        return out
    # x * (1 / (255 std_c)) + (-mean_c / std_c): six floats by value
    scale = [1.0 / (255.0 * s) for s in std]
    bias = [-m / s for m, s in zip(mean, std)]
    lib = _build.load("normalize")
    code = lib.normalize_launch(x.data_ptr(), out.data_ptr(), x.numel(), *scale, *bias,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "normalize_launch")
    normalize_images_cuda.launches += 1
    return out


normalize_images_cuda.launches = 0


def normalize_images(images_u8: torch.Tensor,
                     mean: Sequence[float] = (0.5, 0.5, 0.5),
                     std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """uint8 NHWC -> normalized bf16 NHWC, on the tensor's own device."""
    if images_u8.device.type == "cuda":
        return normalize_images_cuda(images_u8, mean, std)
    if images_u8.device.type == "cpu":
        return normalize_images_reference(images_u8, mean, std)
    raise ValueError(f"normalize_images: unsupported device {images_u8.device}")
