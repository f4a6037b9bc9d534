"""Weight-only int8 and group-wise int4 quantization for the decode engine,
and W8A8 int8 projections for the encoders (counterpart of
``multimodal_colpali_tpu/ops/quant.py``).

Representations, byte for byte the JAX package's:

- int8: each 2-D kernel ``[in, out]`` becomes ``{"q8": int8 codes (same
  shape), "scale": float32 [out]}`` (symmetric per-output-channel absmax);
  the embedding table ``[V, H]`` quantizes per row (``scale: [V]``), padded
  with zero-code rows (scale 1) to a multiple of ``EMBED_PAD``, so the embed
  gather and the tied LM head read the same codes.
- int4: a 2-D kernel ``[K, N]`` becomes ``{"q4": uint8 [K/2, N], "scale":
  float32 [K/G, N]}``, symmetric absmax per (group of G rows, column), codes
  in [-7, 7] stored as code + 8 in a nibble. The packing is split per group,
  not interleaved: within group g, byte row r holds the code of row g*G + r
  in its low nibble and that of row g*G + G/2 + r in its high nibble. The
  embed table stays per-row int8 in this format too.

int8 products run on the codes and the float32 scale multiplies the product:
on a CUDA tensor through K8a (``x @ codes [K, N] * scale``, the projections)
and K8b (``x @ codes [N, K]^T * scale``, the tied LM head) of
``ops/int8_matmul.py``. int4 products dequantize each weight to x's dtype
before the dot: K9 of ``ops/int4_matmul.py`` on a CUDA tensor. On a CPU
tensor each takes its plain version, which repeats the JAX package's XLA
path.

W8A8 (quant.py:262-327), the encoders' ``quantize="int8"``: every dense
projection of an encoder (an ``L.Dense``, a flax 2-D ``kernel``) holds int8
codes ``[out, in]`` and a float32 scale per output channel, made from its
weights in the model's dtype (:func:`quantize_encoder_params`). Its
activations are quantized per row at each call (:func:`quantize_act_int8`),
the codes multiply into exact int32 sums (:func:`int8_mm`:
``torch._int_mm`` on a CUDA tensor, a plain integer product on the CPU) and
the scales follow as a float32 epilogue (:func:`w8a8_dense`). No Pallas
kernel runs this product in JAX either (XLA's ``dot_general``). These
weights are never sent to K8a, whose ``{q8, scale}`` operands are the
decode engine's weight-only ``[in, out]`` codes with bf16 activations.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch.ops._grad import refuse_grad
from multimodal_colpali_tpu_torch.ops.int4_matmul import int4_matmul_kn
from multimodal_colpali_tpu_torch.ops.int8_matmul import int8_matmul_kn, int8_matmul_nk

EMBED_PAD = 512   # quantized embed rows pad to a multiple of this (quant.py:331)


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
    # row-major codes whatever ``w``'s strides (a checkpoint's kernel is a
    # transposed view): the kernels read them contiguous, copying otherwise
    return {"q8": codes.clamp(-127, 127).to(torch.int8).contiguous(), "scale": scale}


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
    tensor, a ``quantize_int8`` dict or a ``quantize_int4`` dict
    (quant.py:62-97). An int8 kernel multiplies the codes and scales the
    product (K8a on a CUDA tensor); an int4 kernel is dequantized to x's
    dtype inside the product (K9 on a CUDA tensor); a CPU tensor takes the
    plain versions."""
    if not (is_quantized(kernel) or is_quantized_int4(kernel)):
        if dense_fn is not None:
            return dense_fn(x, kernel, bias)
        y = x @ kernel
        return y if bias is None else y + bias
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if is_quantized_int4(kernel):
        y = int4_matmul_kn(x2, kernel["q4"], kernel["scale"])
    else:
        y = int8_matmul_kn(x2, kernel["q8"], kernel["scale"])
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


def bf16_matmul_f32(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h [B, H] @ table [V, H]^T`` with bf16 operands and float32 results,
    as an einsum with ``preferred_element_type=float32`` gives them
    (quant.py:123-133 for the tied head; also BERT's projections and the
    dense store's scores): every product is exact and only the sum order can
    differ from a float32 einsum.

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
            return bf16_matmul_f32(hidden_f32, table)
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
    return _quantize_lm_tree(params, "int8")


def quantize_int4(w: torch.Tensor, group: int = 256) -> dict:
    """Group-wise symmetric absmax int4 quantization of ``w [K, N]`` along K
    (quant.py:178-198); K must divide by ``group``. Returns ``{"q4": uint8
    [K/2, N], "scale": float32 [K/G, N]}``, bit for bit the JAX package's."""
    wf = w.float()
    k, n = wf.shape
    if k % group != 0:
        raise ValueError(f"K={k} not divisible by group={group}")
    wg = wf.reshape(k // group, group, n)
    amax = wg.abs().amax(dim=1)                                  # [g, n]
    # tensor divisors: a CUDA division by a Python scalar multiplies by the reciprocal
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 7.0)
    codes = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    codes = (codes + 8.0).to(torch.uint8)                        # 1..15
    half = group // 2
    packed = (codes[:, :half] | (codes[:, half:] << 4)).reshape(k // 2, n)
    return {"q4": packed.contiguous(), "scale": scale.contiguous()}   # as quantize_int8's


def int4_group(qw: dict) -> int:
    """Group size from the shapes: K / scale rows (quant.py:205-207)."""
    return (qw["q4"].shape[0] * 2) // qw["scale"].shape[0]


def dequantize_int4(qw: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The weight of a ``quantize_int4`` dict: ``(code - 8) * scale`` in
    float32, then cast to ``dtype`` (quant.py:210-221)."""
    packed = qw["q4"]
    group = int4_group(qw)
    k2, n = packed.shape
    g = (k2 * 2) // group
    pg = packed.reshape(g, group // 2, n).to(torch.int32)
    full = torch.cat([(pg & 15) - 8, (pg >> 4) - 8], dim=1).float()   # [g, G, n]
    full = full * qw["scale"].float()[:, None, :]
    return full.reshape(g * group, n).to(dtype)


def _int4_group_for(k_dim: int, group: int) -> int:
    """The largest power-of-two-reduced group <= ``group`` that is even and
    divides K (tiny configs have K < 256); 0 when there is none
    (quant.py:224-230)."""
    g = min(group, k_dim)
    while g >= 2 and (k_dim % g or g % 2):
        g //= 2
    return g if g >= 2 and k_dim % g == 0 and g % 2 == 0 else 0


def quantize_lm_params_int4(params: Any, group: int = 256) -> Any:
    """Like :func:`quantize_lm_params`, but kernels become group-wise int4
    (quant.py:233-259): a kernel whose K admits no even group stays int8, and
    the embed table is per-row int8 (left as it is when already quantized)."""
    return _quantize_lm_tree(params, "int4", group)


def quantize_lm_leaf(name: str, w: torch.Tensor, fmt: str, group: int = 256):
    """One leaf as the LM-tree quantizers quantize it: ``embed_tokens`` per
    row int8 (padded); a ``kernel [K, N]`` per column int8, or under
    ``fmt="int4"`` group-wise int4 (int8 where K admits no even group)."""
    if name == "embed_tokens":
        return quantize_embed_int8(w)
    g = _int4_group_for(w.shape[0], group) if fmt == "int4" else 0
    return quantize_int4(w, group=g) if g else quantize_int8(w, axis=0)


def quantize_kernels(tree: Any, fmt: str, group: int = 256) -> Any:
    """Every 2-D ``kernel`` of a tree as :func:`quantize_lm_leaf` makes it
    (an already quantized dict holds none and passes as it is)."""
    if isinstance(tree, dict):
        return {k: (quantize_lm_leaf(k, v, fmt, group)
                    if k == "kernel" and isinstance(v, torch.Tensor) and v.dim() == 2
                    else quantize_kernels(v, fmt, group))
                for k, v in tree.items()}
    return tree


def _quantize_lm_tree(params: Any, fmt: str, group: int = 256) -> Any:
    out = dict(params)
    out["language_model"] = quantize_kernels(params["language_model"], fmt, group)
    emb = dict(params["embed"])
    if not is_quantized(emb["embed_tokens"]):
        emb["embed_tokens"] = quantize_lm_leaf("embed_tokens", emb["embed_tokens"], fmt)
    out["embed"] = emb
    return out


# -- W8A8: the encoders' int8 projections ------------------------------------------

INT_MM_MIN_ROWS = 32   # torch._int_mm on CUDA needs more than 16 rows


def quantize_act_int8(x: torch.Tensor):
    """Per-row (last-dim) symmetric absmax int8 quantization of activations
    -> (codes int8, scale float32 ``[..., 1]``), bit for bit JAX's eager
    result (quant.py:282-289): a zero row keeps scale 1/127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # tensor divisors: a CUDA division by a Python scalar multiplies by the reciprocal
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ w [N, K]^T`` for int8 codes -> int32, exact.

    On a CUDA tensor this is ``torch._int_mm``, whose shape rules (M > 16,
    K and N multiples of 8) are met by zero rows and columns, sliced off
    after: zeros add nothing to an integer sum. On the CPU it is a plain
    int32 product."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ w.to(torch.int32).T
    m, k = a.shape
    n = w.shape[0]
    pk, pn = (-k) % 8, (-n) % 8
    if pk:
        a, w = F.pad(a, (0, pk)), F.pad(w, (0, pk))
    if pn:
        w = F.pad(w, (0, 0, 0, pn))
    if m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(a.contiguous(), w.T)[:m, :n]


def w8a8_dense(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W^T (+ bias)`` for ``W`` held as int8 ``codes [out, in]`` and a
    float32 ``scale [out]`` (quant.py:292-305): x quantized per row, the
    exact int32 product, then ``acc * sx * scale`` and the bias in float32,
    in JAX's order; the result in x's dtype. Rounding x to codes has no
    gradient, so it raises under grad (``ops/_grad.refuse_grad``)."""
    refuse_grad("w8a8_dense", x, codes, scale, bias)
    lead = x.shape[:-1]
    xq, sx = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    y = int8_mm(xq, codes).float() * sx * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*lead, codes.shape[0])


@torch.no_grad()
def quantize_encoder_params(model: torch.nn.Module) -> torch.nn.Module:
    """Every dense projection of ``model`` (each ``models.layers.Dense``: the
    flax tree's 2-D ``kernel`` leaves) becomes int8 codes plus a per-output-
    channel float32 scale, on its device, from its weight as it is (in the
    model's dtype), as quant.py:308-327 rewrites the tree. Convolutions,
    norms, biases, embedding tables and position tables keep their dtype.
    In place; returns ``model``."""
    from multimodal_colpali_tpu_torch.models.layers import Dense

    for mod in model.modules():
        if isinstance(mod, Dense) and mod.weight.dtype != torch.int8:
            q = quantize_int8(mod.weight, axis=1)
            mod.weight = torch.nn.Parameter(q["q8"], requires_grad=False)
            mod.weight_scale = q["scale"]
    return model

