"""Group-wise int4 weight matrix product (counterpart of
``multimodal_colpali_tpu/ops/int4_matmul.py``).

``x [M, K] @ W [K, N]`` where ``W`` is stored as ``ops/quant.quantize_int4``
leaves it: nibbles packed two to a byte, ``packed [K/2, N]`` uint8 (split
per group: low nibbles hold a group's first G/2 rows, high nibbles its second
half, each code + 8), and ``scale [K/G, N]`` float32.

- :func:`int4_matmul_reference` - the plain version, ``int4_matmul_xla``
  (int4_matmul.py:56-63): dequantize to x's dtype, then one matmul.
- :func:`int4_matmul_kn_cuda` - the hand-written kernel K9
  (``csrc/int4_matmul.cu``) that replaces ``_kernel_kn4`` (``pl.pallas_call``
  at int4_matmul.py:134): each weight is scaled in float32 and rounded to
  bf16 before the dot, as the TPU kernel does; float32 accumulation. Both
  tiles dequantize in registers into tensor-core fragments: M <= 16 the
  decode tile (mma.sync), larger M the prefill tile K8a shares (wgmma, TMA;
  ``csrc/wstream.cuh``).
- :func:`int4_matmul_kn` - the dispatcher: a CPU tensor takes the plain
  version, a CUDA tensor the kernel. Every shape with an even group that
  divides K is taken: unlike the TPU dispatch (int4_matmul.py:119-122) there
  is no gate on N.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad
from multimodal_colpali_tpu_torch.ops.int8_matmul import (
    DECODE_ROWS, decode_splits, even_splits, prefill_splits)

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's tiles (csrc/int4_matmul.cu): decode (M <= 16) and prefill
_DECODE_BN, _DECODE_BR = 256, 64   # columns a block, packed byte rows a K step
_PREFILL_BR = 32                   # packed byte rows a stage of the prefill tile


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version of K9: the weight dequantized to x's dtype, one matmul."""
    from multimodal_colpali_tpu_torch.ops.quant import dequantize_int4  # quant imports this module

    return x @ dequantize_int4({"q4": packed, "scale": scale}, x.dtype)


def split_count(m: int, n: int, k: int, sms: int) -> int:
    """How many ranges of packed rows the kernel splits a product into on a
    card of ``sms`` multiprocessors, each range a whole number of K steps and
    none empty. The decode tile (M <= 16) fills one wave of blocks, at least
    8 steps a split (its float32 partial then stays small beside the codes);
    the prefill tile splits only a grid smaller than a wave."""
    if m <= DECODE_ROWS:
        steps = -(-(k // 2) // _DECODE_BR)
        splits = decode_splits(-(-n // _DECODE_BN), steps, sms)
    else:
        steps = -(-(k // 2) // _PREFILL_BR)
        splits = prefill_splits(m, n, steps, sms)
    return even_splits(splits, steps)


def gathers(m: int, group: int) -> bool:
    """Whether the prefill tile takes its gathered path: a stage of 32 byte
    rows may cross a group (G/2 not a multiple of 32), so x is gathered
    element by element and the scales per byte row."""
    return m > DECODE_ROWS and (group // 2) % _PREFILL_BR != 0


def int4_matmul_kn_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K9 on the card: bf16 ``x [M, K]`` times the int4 weight of ``packed
    [K/2, N]`` uint8 and ``scale [K/G, N]`` float32, out in ``out_dtype`` (x's
    by default). G = K / scale rows must be even. Adds one to
    ``int4_matmul_kn_cuda.launches`` per launch, and one to
    ``.decode_launches`` (M <= 16) or ``.prefill_launches`` by the tile;
    a prefill launch on the gathered path (:func:`gathers`) also adds one to
    ``.gathered_launches``."""
    name = "int4_matmul_kn_cuda"
    refuse_grad(name, x, packed, scale)
    if not (x.is_cuda and packed.device == x.device and scale.device == x.device):
        raise ValueError(f"{name} needs x, packed and scale on one CUDA device")
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"{name}: x, packed and scale must be 2-D, got {tuple(x.shape)}, "
                         f"{tuple(packed.shape)}, {tuple(scale.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"{name}: packed must be uint8, got {packed.dtype}")
    m, k = x.shape
    k2, n = packed.shape
    groups = scale.shape[0]
    if k != 2 * k2 or scale.shape[1] != n or groups == 0 or k % groups:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit packed {tuple(packed.shape)} "
                         f"and scale {tuple(scale.shape)}")
    group = k // groups
    if group % 2:
        raise ValueError(f"{name}: the group ({group}) must be even")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    x, packed = x.contiguous(), packed.contiguous()
    scale = scale.to(torch.float32).contiguous()
    splits = split_count(m, n, k, torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.load("int4_matmul")
    code = lib.int4_matmul_launch(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), m, n, k, group,
        _OUT_CODES[out_dtype], splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "int4_matmul_launch")
    int4_matmul_kn_cuda.launches += 1
    if m <= DECODE_ROWS:
        int4_matmul_kn_cuda.decode_launches += 1
    else:
        int4_matmul_kn_cuda.prefill_launches += 1
        int4_matmul_kn_cuda.gathered_launches += gathers(m, group)
    return out


int4_matmul_kn_cuda.launches = 0
int4_matmul_kn_cuda.decode_launches = 0
int4_matmul_kn_cuda.prefill_launches = 0
int4_matmul_kn_cuda.gathered_launches = 0


def int4_matmul_kn(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(packed, scale)``: K9 for a CUDA tensor, the plain version
    for a CPU one."""
    if x.device.type == "cuda":
        return int4_matmul_kn_cuda(x, packed, scale, out_dtype)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale).to(out_dtype or x.dtype)
    raise ValueError(f"int4_matmul_kn: unsupported device {x.device}")
