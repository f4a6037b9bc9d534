"""Weight-only int8 quantization for the decode engine (counterpart of
``multimodal_colpali_tpu/ops/quant.py:36-148, :331-372``).

Representation, byte for byte the JAX package's: each 2-D kernel
``[in, out]`` becomes ``{"q8": int8 codes (same shape), "scale": float32
[out]}`` (symmetric per-output-channel absmax); the embedding table ``[V, H]``
quantizes per row (``scale: [V]``), padded with zero-code rows (scale 1) to a
multiple of ``EMBED_PAD``, so the embed gather and the tied LM head read the
same codes.

The matmul runs on the codes and the float32 scale multiplies the product:
on a CUDA tensor through K8a (``x @ codes [K, N] * scale``, the projections)
and K8b (``x @ codes [N, K]^T * scale``, the tied LM head), the hand-written
kernels of ``ops/int8_matmul.py``; on a CPU tensor through their plain
versions, which repeat the JAX package's XLA path.

The group-wise int4 format (``weight_dtype="int4"``, kernel K9) is not
ported yet and raises.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch.ops.int8_matmul import int8_matmul_kn, int8_matmul_nk

EMBED_PAD = 512   # quantized embed rows pad to a multiple of this (quant.py:331)

_INT4_NOT_PORTED = ("int4 weights (weight_dtype='int4', kernel K9 in ops/int4_matmul.py) "
                    "are not ported yet; see ROADMAP.md queue 2")


def quantize_int8(w: torch.Tensor, axis: int = 0) -> dict:
    """Symmetric absmax int8 quantization of ``w`` along ``axis`` (the
    reduction axis of the matmul it feeds): each slice orthogonal to ``axis``
    gets one float32 scale. Returns ``{"q8", "scale"}``, bit for bit the
    JAX package's (quant.py:36-46)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    # Tensor divisors: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from a true division.
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)
    codes = torch.round(wf / scale.unsqueeze(axis))
    return {"q8": codes.clamp(-127, 127).to(torch.int8), "scale": scale}


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and "q8" in p


def is_quantized_int4(p: Any) -> bool:
    return isinstance(p, dict) and "q4" in p


def dequantize(qw: dict, axis: int = 0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The float weight of a ``quantize_int8`` dict (tests; the compute paths
    keep the codes)."""
    s = qw["scale"].unsqueeze(axis)
    return (qw["q8"].float() * s).to(dtype)


def q_dense(x: torch.Tensor, kernel: Any, bias: Optional[torch.Tensor] = None,
            dense_fn=None) -> torch.Tensor:
    """``x @ kernel (+ bias)`` where ``kernel`` is a plain ``[in, out]``
    tensor or a ``quantize_int8`` dict (quant.py:62-97). The quantized path
    multiplies the codes and scales the product: K8a on a CUDA tensor, its
    plain version on a CPU one."""
    if is_quantized_int4(kernel):
        raise NotImplementedError(_INT4_NOT_PORTED)
    if not is_quantized(kernel):
        if dense_fn is not None:
            return dense_fn(x, kernel, bias)
        y = x @ kernel
        return y if bias is None else y + bias
    lead = x.shape[:-1]
    y = int8_matmul_kn(x.reshape(-1, x.shape[-1]), kernel["q8"], kernel["scale"])
    y = y.reshape(*lead, y.shape[-1])
    return y if bias is None else y + bias


def q_take(table: Any, ids: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Embedding-row gather from a ``[V, H]`` table or a per-row quantized
    dict; rows come back in ``dtype`` with their scales applied."""
    ids = ids.long()
    if not is_quantized(table):
        return table[ids].to(dtype)
    rows = table["q8"][ids].float()
    s = table["scale"][ids]
    return (rows * s[..., None]).to(dtype)


LOGITS_SLICE_ROWS = 16384   # table rows widened to float32 at a time on the CPU


def _bf16_table_logits(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h [B, H] @ table [V, H]^T`` with bf16 operands and float32 results
    (quant.py:123-133): the hidden state comes out of a bf16 stack, so every
    product is exact and only the sum order can differ from a float32 einsum.

    On a CUDA tensor this is ``torch.mm(..., out_dtype=torch.float32)`` (bf16
    products accumulated and returned in float32; no float32 copy of the
    table). On a CPU tensor, which that call does not serve, each slice of the
    table is widened to float32 and multiplied in turn."""
    hb = h.to(torch.bfloat16)
    if h.device.type == "cuda":
        return torch.mm(hb, table.T, out_dtype=torch.float32)
    hf = hb.float()
    out = torch.empty(h.shape[0], table.shape[0], dtype=torch.float32, device=h.device)
    for s in range(0, table.shape[0], LOGITS_SLICE_ROWS):
        out[:, s: s + LOGITS_SLICE_ROWS] = hf @ table[s: s + LOGITS_SLICE_ROWS].float().T
    return out


def q_logits(hidden_f32: torch.Tensor, table: Any,
             out_dim: Optional[int] = None) -> torch.Tensor:
    """Tied LM head ``hidden @ table.T`` in float32 (quant.py:112-148);
    ``hidden_f32`` ``[B, H]`` -> ``[B, V]``. A quantized table goes through
    K8b on a CUDA tensor (bf16 hidden, float32 accumulation, as the TPU
    kernel) and through its plain float32 version on a CPU one; its pad rows
    are sliced off with ``out_dim``."""
    if not is_quantized(table):
        if table.dtype == torch.bfloat16:
            return _bf16_table_logits(hidden_f32, table)
        return hidden_f32 @ table.float().T
    logits = int8_matmul_nk(hidden_f32, table["q8"], table["scale"], out_dtype=torch.float32)
    if out_dim is not None and logits.shape[-1] != out_dim:
        logits = logits[:, :out_dim]
    return logits


def quantize_embed_int8(table: torch.Tensor, pad_to: int = EMBED_PAD) -> dict:
    """Per-row quantization of the embed table, padded with zero-code rows
    (scale 1) to a multiple of ``pad_to`` (quant.py:334-345)."""
    q = quantize_int8(table, axis=1)
    pad = (-table.shape[0]) % pad_to
    if pad:
        q = {"q8": F.pad(q["q8"], (0, 0, 0, pad)),
             "scale": F.pad(q["scale"], (0, pad), value=1.0)}
    return q


def quantize_lm_params(params: Any) -> Any:
    """Every 2-D ``kernel`` under ``language_model`` becomes a per-column
    int8 dict and ``embed.embed_tokens`` a per-row one; norm weights and
    biases stay as they are (quant.py:348-372)."""

    def walk(t):
        if isinstance(t, dict):
            return {k: (quantize_int8(v, axis=0)
                        if k == "kernel" and isinstance(v, torch.Tensor) and v.dim() == 2
                        else walk(v))
                    for k, v in t.items()}
        return t

    out = dict(params)
    out["language_model"] = walk(params["language_model"])
    emb = dict(params["embed"])
    emb["embed_tokens"] = quantize_embed_int8(emb["embed_tokens"])
    out["embed"] = emb
    return out
