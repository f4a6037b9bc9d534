"""Autoregressive decode engines over a Gemma, Qwen2 or Llama LM, and
image-conditioned generation on the ColPali / PaliGemma weights (counterpart
of ``multimodal_colpali_tpu/generation/engine.py:69-646, :649-898``).

The engine serves the text LM of a Gemma-1 (ColPali's PaliGemma LM) or
Gemma-3 parameter tree: the JAX layout, kept as a nested dict (``embed`` and
``language_model`` subtrees, dense kernels ``[in, out]``, ``{"q8", "scale"}``
dicts for int8 weights). The layer math follows the JAX package step for
step; where the JAX engine jits a whole generation, this one runs eagerly:

- ``generate`` left-pads prompts to a shared length bucket, prefills them
  into ``[B, S + N, Hkv, D]`` caches and decodes one token a step, with the
  JAX package's masks, positions and rounding points, so CPU streams are
  token-identical to the JAX engine's.
- Caches are written in place (JAX returns updated copies).
- Sampling (``temperature > 0``) is a counter-based Gumbel-max in plain
  PyTorch on the device: the noise of token ``i`` at request step ``n`` is a
  hash of (seed, n, i). JAX's threefry bits cannot be reproduced, so sampled
  streams differ from the JAX package's; the property JAX promises still
  holds: a (prompt, seed, temperature) triple gives the same stream whatever
  the slot, the batch or the admission timing, and ``generate`` and the
  batchers agree. Greedy streams and ``filter_top_p_top_k`` equal JAX's.

``Qwen2DecodeEngine`` and ``LlamaDecodeEngine`` run the Qwen2/Llama body
(plain RMSNorm, q/k/v biases for Qwen2, mrope, a SiLU MLP) with unscaled
embeddings and a tied or untied head; the old-model image engines
(``generation/qwen2vl_mm.py``, ``generation/llava_next_mm.py``) decode
through them.

``PaliGemmaEngine`` puts page images in front of the prompt: the retriever's
SigLIP tower (K2 on the card) and projector fill the ``<image>`` slots, the
prompt attends bidirectionally with 1-indexed positions, and generation runs
through a ``GemmaDecodeEngine`` over the same text weights.

Projections go through ``ops/quant.q_dense`` (K8a under
``weight_dtype="int8"``, K9 under ``"int4"``), the tied LM head through
``q_logits`` (K8b for the int8 embed table of both quantized formats), and
prefill attention through the plain masked einsum of ``models/layers``, as in
the JAX engine.

Over a mesh (``mesh=``, axes ``data`` and ``model``; engine.py:347-398) each
rank of the ``model`` axis holds ``parallel.shard_params_for_tp``'s slices of
the text tree: whole query heads, the KV heads that serve them, and a slice
of the MLP's hidden units; the embedding and the head are replicated. The
layer bodies all-reduce over the ``model`` group after ``o_proj`` and
``down_proj`` (:func:`_row`). KV heads shard only where
``num_key_value_heads`` divides the axis (JAX's pool rule, paged.py:170-171);
otherwise every rank keeps the KV head its query heads read, and its query
heads must lie within one GQA group. The engine's ``cfg`` is then the
rank's (:class:`RankConfig`: its head counts), so caches and pools hold the
rank's heads; ``model_cfg`` is the model's. ``generate`` pads the batch to a
multiple of the ``data`` size, each data rank decodes its share of the rows,
and the tokens are all-gathered (engine.py:577-598).

An image engine's ``lm`` may be such an engine. Its tower and projector run
whole on every rank (JAX replicates their leaves), and its prompt goes
through the LM's layers at the rank's heads (the ``lm.cfg`` it reads);
Mllama's cross blocks are cut like the LM's layers. The batchers serve it
over the mesh through their admission records (``generation/scheduler``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.ops.int4_matmul import int4_matmul_kn
from multimodal_colpali_tpu_torch.ops.int8_matmul import int8_matmul_kn
from multimodal_colpali_tpu_torch.ops.quant import (
    is_quantized, is_quantized_int4, q_dense, q_logits, q_take, quantize_lm_params,
    quantize_lm_params_int4)
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties
from multimodal_colpali_tpu_torch.parallel.mesh import (
    all_reduce, batch_sharding, shard_params_for_tp, tp_head_plan)

LOGPROB_K = 5   # top alternatives recorded per decode step (OpenAI cap)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma RMSNorm, ``x / rms(x) * (1 + w)`` in float32 (engine.py:69-72)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w)).to(x.dtype)


def _dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """``x @ kernel [in, out]`` in x's dtype; a bias is added to the float32
    product before the cast (models/layers.py:18-36). On the card a bf16
    product is accumulated and returned in float32 by ``torch.mm(...,
    out_dtype=torch.float32)``, with no float32 copy of the kernel."""
    if bias is None:
        return x @ kernel.to(x.dtype)
    if x.device.type == "cuda" and x.dtype == kernel.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), kernel, out_dtype=torch.float32)
        return (y + bias.float()).to(x.dtype).reshape(*x.shape[:-1], kernel.shape[1])
    return (x.float() @ kernel.float() + bias.float()).to(x.dtype)


def _lin(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    return q_dense(x, p["kernel"], p.get("bias"), dense_fn=_dense)


def _row(x: torch.Tensor, p: Dict[str, Any], c) -> torch.Tensor:
    """A row-parallel projection (``o_proj``, ``down_proj``): on a mesh
    (``c`` a :class:`RankConfig`) each rank multiplies its slice of the input
    dimension, the partial products are summed over the ``model`` group, and
    a bias is added once, after the sum."""
    mesh = getattr(c, "mesh", None)
    if mesh is None:
        return _lin(x, p)
    y = all_reduce(mesh, "model", q_dense(x, p["kernel"], None, dense_fn=_dense))
    if p.get("bias") is not None:
        y = (y.float() + p["bias"].float()).to(y.dtype)
    return y


class RankConfig:
    """A text config as one rank of a tensor-parallel mesh sees it: its own
    query and KV head counts and the ``mesh`` its row-parallel projections
    reduce over; every other field reads through to ``model_cfg``."""

    def __init__(self, model_cfg: Any, mesh: Any, num_attention_heads: int,
                 num_key_value_heads: int):
        self.model_cfg = model_cfg
        self.mesh = mesh
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads

    def __getattr__(self, name: str) -> Any:
        if name == "model_cfg":
            raise AttributeError(name)
        return getattr(self.model_cfg, name)


def _cols(p: Any, lo: int, hi: int) -> Any:
    """Output columns ``[lo, hi)`` of a projection subtree (kernel or int8
    codes by column, bias or scale by entry)."""
    if isinstance(p, dict):
        return {k: _cols(v, lo, hi) for k, v in p.items()}
    return p[..., lo:hi].contiguous()


def tp_engine_params(params: Any, cfg: Any, mesh: Any, attention=None):
    """This rank's slices of an engine tree and its :class:`RankConfig`.
    ``attention(tree)`` lists the tree's attention subtrees (default: the
    LM's ``self_attn`` of every layer), whose K/V projections keep the
    rank's KV head where the KV heads do not split."""
    q0, nq, k0, nkv = tp_head_plan(cfg, mesh.size("model"), mesh.index("model"))
    if nkv * mesh.size("model") == cfg.num_key_value_heads:
        return shard_params_for_tp(params, mesh, "model"), RankConfig(cfg, mesh, nq, nkv)
    params = shard_params_for_tp(params, mesh, "model", replicated=("k_proj", "v_proj"))
    d = cfg.head_dim
    if attention is None:
        attention = lambda t: [t["language_model"][f"layers_{i}"]["self_attn"]  # noqa: E731
                               for i in range(cfg.num_hidden_layers)]
    for att in attention(params):
        for name in ("k_proj", "v_proj"):
            att[name] = _cols(att[name], k0 * d, (k0 + nkv) * d)
    return params, RankConfig(cfg, mesh, nq, nkv)


def _rope_tables(positions: torch.Tensor, theta: float, d: int):
    """cos/sin ``[B, S, 1, D/2]`` of ``models/layers.rope`` for one (positions, theta)."""
    exps = torch.arange(0, d // 2, dtype=torch.float32, device=positions.device) * 2.0 / d
    freq = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freq
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x: torch.Tensor, tables) -> torch.Tensor:
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def filter_top_p_top_k(logits: torch.Tensor, top_p, top_k) -> torch.Tensor:
    """Nucleus (top-p) and top-k filtering, vLLM-style (engine.py:81-111):
    the caller applies temperature first. ``top_p``/``top_k`` broadcast over
    the leading axes; ``top_p >= 1`` and ``top_k <= 0`` leave the logits as
    they are. The best token always survives."""
    v = logits.shape[-1]
    batch = logits.shape[:-1]
    dev = logits.device
    top_p = torch.as_tensor(top_p, dtype=logits.dtype, device=dev).broadcast_to(batch)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).broadcast_to(batch)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, torch.full_like(top_k, v)) - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_desc, -1, k_idx[..., None])
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[..., None]
    keep[..., 0] = True
    cutoff = torch.where(keep, sorted_desc, torch.full_like(sorted_desc, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    mask = (logits >= kth) & (logits >= cutoff)
    return torch.where(mask, logits, torch.full_like(logits, float("-inf")))


_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) on int64 tensors holding uint32 values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: torch.Tensor, step: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise ``[B, vocab]`` in float64, a pure function of each row's
    (seed, step) and the token index: the counter-based stand-in for
    ``jax.random.categorical(fold_in(PRNGKey(seed), step), ...)``."""
    seed = seed.to(torch.int64).reshape(-1, 1) & _M32
    step = step.to(torch.int64).reshape(-1, 1) & _M32
    key = _hash32(_hash32(seed) ^ ((step * 0x9E3779B9) & _M32))
    idx = torch.arange(vocab, dtype=torch.int64, device=seed.device)[None, :]
    h1 = _hash32(key ^ idx)
    h2 = _hash32(h1 ^ 0x5BD1E995)
    u = (h1.double() * 4294967296.0 + h2.double() + 0.5) / 18446744073709551616.0
    return -torch.log(-torch.log(u))


def sample_per_slot(logits: torch.Tensor, seed: torch.Tensor, gen_step: torch.Tensor,
                    temp: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor,
                    use_filter: bool = True) -> torch.Tensor:
    """Per-slot next token (engine.py:114-133): rows with ``temp <= 0``
    decode greedily (argmax, lowest index on ties); the others draw from
    ``softmax(filter(logits / max(temp, 1e-3)))`` with noise keyed by the
    row's own (seed, step)."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temp.to(logits.dtype), min=1e-3)[:, None]
    if use_filter:
        scaled = filter_top_p_top_k(scaled, top_p, top_k)
    sampled = torch.argmax(scaled.double() + gumbel_noise(seed, gen_step, logits.shape[-1]),
                           dim=-1)
    return torch.where(temp > 0, sampled, greedy).to(torch.int32)


def _step_logprobs(logits: torch.Tensor, nxt: torch.Tensor):
    """The chosen token's logprob and the top-``LOGPROB_K`` alternatives of
    the raw distribution (engine.py:139-148); ties by lower index."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lp = torch.gather(logp, -1, nxt.long()[:, None])[:, 0]
    tlp, tid = topk_with_stable_ties(logp, LOGPROB_K)
    return lp, tid, tlp


def attn_scale(c) -> float:
    """Gemma-3 scales logits by ``query_pre_attn_scalar ** -0.5``, Gemma-1 by head_dim's."""
    return float(getattr(c, "query_pre_attn_scalar", None) or c.head_dim) ** -0.5


def layer_stack(p, c, x: torch.Tensor, positions: torch.Tensor, kv_write, attend,
                interleave=None):
    """The Gemma per-layer decode body (engine.py:159-218), shared by every
    decode path. ``kv_write(i, k, v) -> (kc, vc)`` stores layer i's K/V rows
    ``[B, S, Hkv, D]`` and returns what ``attend(i, q, kc, vc)`` reads; the
    attention may come back in any shape that reshapes to ``[B, S, Hq * D]``.
    Returns (hidden after the final norm, (k caches, v caches))."""
    if getattr(c, "is_qwen2", False) or getattr(c, "is_llama", False):
        return _layer_stack_qwen2(p, c, x, positions, kv_write, attend, interleave)
    if interleave is not None:
        raise NotImplementedError("interleave hooks belong to the Qwen2/Llama body")
    if getattr(c, "is_gemma3", False):
        return _layer_stack_gemma3(p, c, x, positions, kv_write, attend)
    b, s, _ = x.shape
    tables = _rope_tables(positions, c.rope_theta, c.head_dim)
    new_k, new_v = [], []
    for i in range(c.num_hidden_layers):
        lp = p["language_model"][f"layers_{i}"]
        y = _rms(x, lp["input_layernorm"]["weight"], c.rms_norm_eps)
        q = _lin(y, lp["self_attn"]["q_proj"]).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = _lin(y, lp["self_attn"]["k_proj"]).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = _lin(y, lp["self_attn"]["v_proj"]).reshape(b, s, c.num_key_value_heads, c.head_dim)
        q, k = _rope(q, tables), _rope(k, tables)
        kc, vc = kv_write(i, k, v)
        new_k.append(kc)
        new_v.append(vc)
        att = attend(i, q, kc, vc)
        x = x + _row(att.reshape(b, s, -1), lp["self_attn"]["o_proj"], c)
        y = _rms(x, lp["post_attention_layernorm"]["weight"], c.rms_norm_eps)
        gate = _lin(y, lp["mlp"]["gate_proj"])
        up = _lin(y, lp["mlp"]["up_proj"])
        x = x + _row(F.gelu(gate, approximate="tanh") * up, lp["mlp"]["down_proj"], c)
    x = _rms(x, p["language_model"]["norm"]["weight"], c.rms_norm_eps)
    return x, (tuple(new_k), tuple(new_v))


def _layer_stack_gemma3(p, c, x: torch.Tensor, positions: torch.Tensor, kv_write, attend):
    """Gemma-3 body (engine.py:221-266): q/k RMSNorm before rope; sliding
    layers rope at ``rope_local_base_freq`` on plain positions, global ones
    at ``rope_theta`` on positions divided by ``rope_scaling_factor``;
    sandwich norms around both residual branches. The caller's ``attend``
    applies the sliding window."""
    b, s, _ = x.shape
    types = c.layer_types_resolved
    tables = {
        True: _rope_tables(positions, c.rope_local_base_freq, c.head_dim),
        False: _rope_tables(positions.float() / torch.full(
            (), c.rope_scaling_factor, dtype=torch.float32, device=positions.device),
            c.rope_theta, c.head_dim),
    }
    new_k, new_v = [], []
    for i in range(c.num_hidden_layers):
        lp = p["language_model"][f"layers_{i}"]
        rope_t = tables[types[i] == "sliding_attention"]
        y = _rms(x, lp["input_layernorm"]["weight"], c.rms_norm_eps)
        q = _lin(y, lp["self_attn"]["q_proj"]).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = _lin(y, lp["self_attn"]["k_proj"]).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = _lin(y, lp["self_attn"]["v_proj"]).reshape(b, s, c.num_key_value_heads, c.head_dim)
        q = _rms(q, lp["self_attn"]["q_norm"]["weight"], c.rms_norm_eps)
        k = _rms(k, lp["self_attn"]["k_norm"]["weight"], c.rms_norm_eps)
        q, k = _rope(q, rope_t), _rope(k, rope_t)
        kc, vc = kv_write(i, k, v)
        new_k.append(kc)
        new_v.append(vc)
        att = attend(i, q, kc, vc)
        att_out = _row(att.reshape(b, s, -1), lp["self_attn"]["o_proj"], c)
        x = x + _rms(att_out, lp["post_attention_layernorm"]["weight"], c.rms_norm_eps)
        y = _rms(x, lp["pre_feedforward_layernorm"]["weight"], c.rms_norm_eps)
        gate = _lin(y, lp["mlp"]["gate_proj"])
        up = _lin(y, lp["mlp"]["up_proj"])
        ff = _row(F.gelu(gate, approximate="tanh") * up, lp["mlp"]["down_proj"], c)
        x = x + _rms(ff, lp["post_feedforward_layernorm"]["weight"], c.rms_norm_eps)
    x = _rms(x, p["language_model"]["norm"]["weight"], c.rms_norm_eps)
    return x, (tuple(new_k), tuple(new_v))


def _rms_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Qwen2's / Llama's RMSNorm, ``x / rms(x) * w`` in float32 (engine.py:269-273)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _layer_stack_qwen2(p, c, x: torch.Tensor, positions: torch.Tensor, kv_write, attend,
                       interleave=None):
    """The Qwen2(-VL) and Llama body (engine.py:276-340): plain RMSNorm,
    q/k/v projections with biases where the tree has them (Qwen2; Llama's
    have none), mrope from ``positions`` ``[B, S]`` (text: the three streams
    equal) or ``[3, B, S]`` (an image prompt's temporal / height / width
    streams; Llama's config puts every channel on the first), a SiLU-gated
    MLP. ``interleave`` maps a layer index to a hook ``x -> x`` run before
    that layer (``num_hidden_layers``: after the last, before the final norm).
    The injection contract is :func:`layer_stack`'s."""
    from multimodal_colpali_tpu_torch.models.qwen2vl import mrope_cos_sin

    b, s, _ = x.shape
    pos3 = positions[None].expand(3, *positions.shape) if positions.dim() == 2 else positions
    cos, sin = mrope_cos_sin(c, pos3)              # [B, S, head_dim] float32
    cosb, sinb = cos[:, :, None, :], sin[:, :, None, :]

    def rot(t):
        tf = t.float()
        half = tf.shape[-1] // 2
        rh = torch.cat([-tf[..., half:], tf[..., :half]], dim=-1)
        return ((tf * cosb) + (rh * sinb)).to(t.dtype)

    new_k, new_v = [], []
    for i in range(c.num_hidden_layers):
        if interleave is not None and i in interleave:
            x = interleave[i](x)
        lp = p["language_model"][f"layers_{i}"]
        y = _rms_plain(x, lp["input_layernorm"]["weight"], c.rms_norm_eps)
        q = _lin(y, lp["self_attn"]["q_proj"]).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = _lin(y, lp["self_attn"]["k_proj"]).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = _lin(y, lp["self_attn"]["v_proj"]).reshape(b, s, c.num_key_value_heads, c.head_dim)
        q, k = rot(q), rot(k)
        kc, vc = kv_write(i, k, v)
        new_k.append(kc)
        new_v.append(vc)
        att = attend(i, q, kc, vc)
        x = x + _row(att.reshape(b, s, -1), lp["self_attn"]["o_proj"], c)
        y = _rms_plain(x, lp["post_attention_layernorm"]["weight"], c.rms_norm_eps)
        gate = _lin(y, lp["mlp"]["gate_proj"])
        up = _lin(y, lp["mlp"]["up_proj"])
        x = x + _row(F.silu(gate) * up, lp["mlp"]["down_proj"], c)
    if interleave is not None and c.num_hidden_layers in interleave:
        x = interleave[c.num_hidden_layers](x)
    x = _rms_plain(x, p["language_model"]["norm"]["weight"], c.rms_norm_eps)
    return x, (tuple(new_k), tuple(new_v))


def _tree_to(t: Any, device: torch.device, dtype: torch.dtype) -> Any:
    """Every tensor leaf onto ``device``; float32 leaves cast to ``dtype``."""
    if isinstance(t, dict):
        return {k: _tree_to(v, device, dtype) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.to(device, dtype) if t.dtype == torch.float32 else t.to(device)
    return t


def left_pad(prompts: Sequence[Sequence[int]], s: int, pad_id: int):
    """``[B, s]`` ids and mask with each prompt right-aligned (int64 numpy)."""
    ids = np.full((len(prompts), s), pad_id, np.int64)
    mask = np.zeros((len(prompts), s), np.int64)
    for n, pr in enumerate(prompts):
        if len(pr):
            ids[n, -len(pr):] = pr
            mask[n, -len(pr):] = 1
    return ids, mask


@dataclasses.dataclass
class GemmaDecodeEngine:
    """Causal Gemma LM over a ColPali-style parameter tree (``embed`` and
    ``language_model`` subtrees; anything else is ignored), on ``device``.

    ``weight_dtype="int8"`` quantizes the kernels and the embed table on the
    device (``ops/quant.quantize_lm_params``), ``"int4"`` the kernels
    group-wise int4 and the embed table int8 (``quantize_lm_params_int4``); a
    tree that is already quantized is used as it is, its format read from its
    leaves (engine.py:360-393). ``mesh`` (``parallel.get_mesh`` with
    ``data`` and ``model`` axes) runs the engine tensor- and data-parallel
    (see the module docstring) in native and int8 weights; int4 with a mesh
    is a ``ValueError``, as in JAX (engine.py:387-393)."""

    cfg: Any
    params: Any
    dtype: torch.dtype = torch.float32
    mesh: Any = None
    weight_dtype: str = "native"     # "native" | "int8" | "int4"
    device: Any = "cuda"
    # with record_top2 set, every generate (this engine's and a PaliGemmaEngine's
    # over it) leaves the gap between the top two logits of each step in
    # top2_gaps [B, max_new_tokens]: how close a greedy choice came to a tie
    record_top2 = False
    top2_gaps = None

    def __post_init__(self):
        if self.weight_dtype not in ("native", "int8", "int4"):
            raise ValueError(f"weight_dtype must be 'native', 'int8' or 'int4', "
                             f"got {self.weight_dtype!r}")
        self.device = resolve_device(self.device)
        self.model_cfg = self.cfg
        keep = {"embed": self.params["embed"], "language_model": self.params["language_model"]}
        emb = keep["embed"]["embed_tokens"]
        if is_quantized(emb) or is_quantized_int4(emb):
            # already quantized by a sibling engine: never re-cast (the
            # float32 scales would degrade to the model dtype)
            self.weight_dtype = _detect_quantized_dtype(keep["language_model"])
            params = _tree_to(keep, self.device, torch.float32)
        else:
            params = _tree_to(keep, self.device, self.dtype)
            if self.weight_dtype == "int8":
                params = quantize_lm_params(params)
            elif self.weight_dtype == "int4":
                params = quantize_lm_params_int4(params)
        if self.mesh is not None:
            if self.weight_dtype == "int4":
                # group packing does not split on arbitrary K boundaries
                raise ValueError("weight_dtype='int4' does not support TP meshes; use 'int8' "
                                 "or 'native' when sharding")
            self.mesh.check(torch.empty(0, device=self.device))
            params, self.cfg = tp_engine_params(params, self.cfg, self.mesh)
        self.params = params

    # -- layer math ----------------------------------------------------------

    def _embed(self, p, ids: torch.Tensor) -> torch.Tensor:
        x = q_take(p["embed"]["embed_tokens"], ids, torch.float32)
        scale = torch.full((), self.cfg.hidden_size ** 0.5, dtype=torch.float32, device=x.device)
        return (x * scale).to(self.dtype)

    def _chunk(self, p, x, positions, kcaches, vcaches, write_idx: int, kv_valid,
               causal: bool = True, interleave=None):
        """Run a chunk of tokens through all layers (engine.py:407-451),
        writing K/V into the caches at ``write_idx`` (in place) and attending
        under ``kv_valid [B, T]`` plus, when ``causal``, global causality.
        x ``[B, S, H]``; positions ``[B, S]``; ``interleave`` as
        :func:`layer_stack`'s (Mllama's cross blocks)."""
        c = self.cfg
        b, s, _ = x.shape
        t = kcaches[0].shape[1]
        dev = x.device
        cols = torch.arange(t, device=dev)
        mask = kv_valid.bool()[:, None, None, :]
        gq = write_idx + torch.arange(s, device=dev)
        if causal:
            mask = mask & (cols[None, :] <= gq[:, None])[None, None]
        mask = mask.expand(b, 1, s, t)
        sliding = (c.layer_types_resolved if getattr(c, "is_gemma3", False) else None)
        if sliding is not None:
            sl_mask = mask & (cols[None, :] > (gq - c.sliding_window)[:, None])[None, None]
        sc = attn_scale(c)

        def kv_write(i, k, v):
            kcaches[i][:, write_idx: write_idx + s] = k
            vcaches[i][:, write_idx: write_idx + s] = v
            return kcaches[i], vcaches[i]

        def attend(i, q, kc, vc):
            m = mask
            if sliding is not None and sliding[i] == "sliding_attention":
                m = sl_mask
            return L.attention(q, kc, vc, mask=m, scale=sc)

        return layer_stack(p, c, x, positions, kv_write, attend, interleave)

    def _logits(self, p, hidden: torch.Tensor) -> torch.Tensor:
        """Tied LM head in float32, sliced back to the true vocab."""
        return q_logits(hidden.float(), p["embed"]["embed_tokens"], out_dim=self.cfg.vocab_size)

    def _caches(self, b: int, t: int):
        c = self.cfg
        shape = (b, t, c.num_key_value_heads, c.head_dim)
        return ([torch.zeros(shape, dtype=self.dtype, device=self.device)
                 for _ in range(c.num_hidden_layers)],
                [torch.zeros(shape, dtype=self.dtype, device=self.device)
                 for _ in range(c.num_hidden_layers)])

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _data_rows(self, prompts: Sequence[Sequence[int]], pad_id: int) -> List[Sequence[int]]:
        """This data rank's prompts: the batch padded with one-token pad
        prompts to a multiple of the ``data`` size (engine.py:577-583), then
        the rank's share; every prompt without a mesh."""
        if self.mesh is None:
            return list(prompts)
        rows = list(prompts) + [[pad_id]] * ((-len(prompts)) % self.mesh.size("data"))
        lo, hi = batch_sharding(self.mesh).bounds(len(rows))
        return rows[lo:hi]

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, in order (``t`` itself without a mesh)."""
        return batch_sharding(self.mesh).gather(t) if self.mesh is not None else t

    # -- generation ----------------------------------------------------------

    @torch.inference_mode()
    def next_token_logits(self, prompts: Sequence[Sequence[int]], pad_id: int = 0,
                          bucket: int = 16) -> np.ndarray:
        """Prefill only: float32 next-token logits per prompt ``[B, V]``."""
        s = max(max(len(pr) for pr in prompts), 1)
        s = ((s + bucket - 1) // bucket) * bucket
        rows = self._data_rows(prompts, pad_id)
        ids, mask = (self._tensor(a) for a in left_pad(rows, s, pad_id))
        kc, vc = self._caches(len(rows), s)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        hidden, _ = self._chunk(self.params, self._embed(self.params, ids), positions,
                                kc, vc, 0, mask.bool())
        logits = self._gather_rows(self._logits(self.params, hidden[:, -1]))
        return logits[: len(prompts)].cpu().numpy()

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 64,
                 temperature: float = 0.0, eos_id: int = -1, pad_id: int = 0,
                 seed: int = 0, bucket: int = 16, top_p: float = 1.0,
                 top_k: int = 0) -> List[List[int]]:
        """Continuations of token-id prompts (engine.py:553-609): prompts are
        left-padded to a shared bucket, outputs cut at ``eos_id``."""
        if not prompts:
            return []
        p = self.params
        s = max(max(len(pr) for pr in prompts), 1)
        s = ((s + bucket - 1) // bucket) * bucket
        rows = self._data_rows(prompts, pad_id)
        b = len(rows)
        ids, mask = (self._tensor(a) for a in left_pad(rows, s, pad_id))
        kc, vc = self._caches(b, s + max_new_tokens)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        kv_valid = torch.cat([mask.bool(), torch.ones((b, max_new_tokens), dtype=torch.bool,
                                                       device=self.device)], dim=1)
        hidden, _ = self._chunk(p, self._embed(p, ids), positions, kc, vc, 0, kv_valid)
        out = self._decode(hidden[:, -1], positions[:, -1], kc, vc, s, kv_valid,
                           max_new_tokens, temperature, eos_id, pad_id, seed, top_p, top_k,
                           gather=True)
        return out[: len(prompts)]

    def _decode(self, last_hidden, last_pos, kc, vc, s: int, kv_valid, max_new_tokens: int,
                temperature: float, eos_id: int, pad_id: int, seed: int, top_p: float,
                top_k: int, interleave=None, gather: bool = False) -> List[List[int]]:
        """Sample from the prefill's last hidden state, then decode one token
        a step into caches ``[B, s + max_new_tokens]`` at rows ``s``...,
        every step through ``interleave``'s hooks; rows cut at ``eos_id``.
        ``gather`` returns every data rank's rows, in order."""
        p = self.params
        b = last_hidden.shape[0]
        vec = lambda v, dt: torch.full((b,), v, dtype=dt, device=self.device)  # noqa: E731
        temp, tp, tk = (vec(temperature, torch.float32), vec(top_p, torch.float32),
                        vec(top_k, torch.int64))
        seeds = vec(seed, torch.int64)
        use_filter = top_p < 1.0 or top_k > 0
        gaps = []

        def sample(logits, step):
            if self.record_top2:
                top2 = torch.topk(logits, 2, dim=-1).values
                gaps.append(top2[:, 0] - top2[:, 1])
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            return sample_per_slot(logits, seeds, vec(step, torch.int64), temp, tp, tk,
                                   use_filter=use_filter)

        tok = sample(self._logits(p, last_hidden), 0)
        done = tok == eos_id
        out = [tok]
        for step in range(1, max_new_tokens):
            hidden, _ = self._chunk(p, self._embed(p, tok[:, None]),
                                    (last_pos + step)[:, None], kc, vc, s + step - 1,
                                    kv_valid, interleave=interleave)
            nxt = sample(self._logits(p, hidden[:, -1]), step)
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
        rows = torch.stack(out, dim=1)
        rows = (self._gather_rows(rows) if gather else rows).cpu().numpy()
        if gaps:
            g = torch.stack(gaps, dim=1)
            self.top2_gaps = (self._gather_rows(g) if gather else g).cpu().numpy()
        results: List[List[int]] = []
        for row in rows:
            toks = row.tolist()
            if eos_id in toks:
                toks = toks[: toks.index(eos_id)]
            results.append(toks)
        return results


def _head_logits(hidden_f32: torch.Tensor, kernel: Any) -> torch.Tensor:
    """An untied LM head ``hidden @ kernel [H, V]`` in float32 (engine.py:
    626-635, where JAX's ``L.dense`` multiplies float32 hidden by the kernel
    cast to float32). Hidden holds model-dtype values, so on the card a bf16
    kernel is one ``torch.mm`` of bf16 operands with float32 accumulation and
    output, and an int8 / int4 kernel is K8a / K9 with float32 output: every
    product exact, only the sum order can differ."""
    h = hidden_f32
    on_card = h.device.type == "cuda"
    if is_quantized(kernel) or is_quantized_int4(kernel):
        x = h.to(torch.bfloat16) if on_card else h
        if is_quantized_int4(kernel):
            return int4_matmul_kn(x, kernel["q4"], kernel["scale"], out_dtype=torch.float32)
        return int8_matmul_kn(x, kernel["q8"], kernel["scale"], out_dtype=torch.float32)
    if on_card and kernel.dtype == torch.bfloat16:
        return torch.mm(h.to(torch.bfloat16), kernel, out_dtype=torch.float32)
    return h @ kernel.float()


@dataclasses.dataclass
class Qwen2DecodeEngine(GemmaDecodeEngine):
    """Causal Qwen2 LM (the text stack of Qwen2-VL) over an engine tree
    (engine.py:613-635). The layer body is :func:`_layer_stack_qwen2`, chosen
    by the config's ``is_qwen2`` marker, so every decode path (``generate``,
    both batchers, the speculative verify) serves it. Embeddings are not
    scaled; the head is ``language_model.lm_head`` where the tree has one
    (untied, sliced to the vocab), else the embedding table."""

    def _embed(self, p, ids: torch.Tensor) -> torch.Tensor:
        return q_take(p["embed"]["embed_tokens"], ids, torch.float32).to(self.dtype)

    def _logits(self, p, hidden: torch.Tensor) -> torch.Tensor:
        lm = p["language_model"]
        if "lm_head" in lm:
            return _head_logits(hidden.float(), lm["lm_head"]["kernel"])[
                ..., : self.cfg.vocab_size]
        return q_logits(hidden.float(), p["embed"]["embed_tokens"], out_dim=self.cfg.vocab_size)


@dataclasses.dataclass
class LlamaDecodeEngine(Qwen2DecodeEngine):
    """Causal Llama LM (engine.py:638-646): Qwen2's engine math, the body
    without biases and with plain rotary (the config's ``is_llama``). The LM
    of AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B."""


class _ImageEngine:
    """What both image engines share: the pixels on the LM's device, the
    tower over every image of a batch, the prefill of the merged prompt, and
    ``generate`` / ``next_token_logits`` over it, decoding through ``lm``.
    An engine sets ``cfg``, ``vision_tower`` and ``lm``, supplies
    ``_project``, ``_merge``, ``_prefill_embeds`` and ``build_mm_prompt``,
    and declares what the batchers read: ``first_position``, the prompt's
    first position (:meth:`prompt_positions` counts on from it; an engine
    with mrope overrides that), ``tokens_per_image`` where prompts share
    prefix pages, and ``shares_prefix_pages``, whether image prompts may
    share them. ``pixel_values`` are normalized NHWC, ``[B, H, W, 3]`` or ``[B, N,
    H, W, 3]`` for N images a row."""

    batcher_compatible = True
    image_rank = 3          # one image is [H, W, 3]
    first_position: int
    shares_prefix_pages: bool

    def _pixels(self, pixel_values) -> torch.Tensor:
        if not isinstance(pixel_values, torch.Tensor):
            pixel_values = torch.from_numpy(np.asarray(pixel_values))
        return pixel_values.to(self.lm.device)

    def _tower(self, pix: torch.Tensor) -> torch.Tensor:
        """``[B, N, H, W, 3]`` (or ``[B, H, W, 3]``) -> patches ``[B * N, P, hidden]``."""
        if pix.dim() == 4:
            pix = pix[:, None]                       # [B, 1, H, W, 3]
        return self.vision_tower(pix.reshape((-1,) + tuple(pix.shape[2:])).to(self.lm.dtype))

    def _image_features(self, pix: torch.Tensor) -> torch.Tensor:
        return self._project(self._tower(pix), pix.shape[0])

    def prompt_positions(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Each token's position ``[B, S]`` in a left-padded image prompt;
        the last column is where decoding goes on from. An engine whose
        prompt has more than one position stream (Qwen2-VL's mrope) gives
        the largest."""
        return torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0) + self.first_position

    def _merged_embeds(self, ids: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
        return self._merge(ids, self._image_features(pix))

    def prefill(self, ids: torch.Tensor, mask: torch.Tensor, pix: torch.Tensor, kc, vc):
        """The image prompt over ``ids``/``mask [B, s]`` into the caches'
        first ``s`` rows -> (hidden, (k, v), positions from ``first_position``)."""
        return self._prefill_embeds(ids, mask, self._merged_embeds(ids, pix), kc, vc)

    def _padded(self, prompts: Sequence[Sequence[int]], pad_id: int, bucket: int):
        s = max(max(len(pr) for pr in prompts), 1)
        s = ((s + bucket - 1) // bucket) * bucket
        ids, mask = (self.lm._tensor(a) for a in left_pad(prompts, s, pad_id))
        return s, ids, mask

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], pixel_values,
                 max_new_tokens: int = 32, temperature: float = 0.0, eos_id: int = -1,
                 pad_id: int = 0, seed: int = 0, bucket: int = 16, top_p: float = 1.0,
                 top_k: int = 0) -> List[List[int]]:
        """Image-conditioned continuations (engine.py:769-800,
        gemma3_mm.py:236-267) of prompts that already hold their image tokens
        (:meth:`build_mm_prompt`)."""
        eng = self.lm
        s, ids, mask = self._padded(prompts, pad_id, bucket)
        b = len(prompts)
        kc, vc = eng._caches(b, s + max_new_tokens)
        hidden, _, positions = self.prefill(ids, mask, self._pixels(pixel_values), kc, vc)
        kv_valid = torch.cat([mask.bool(), torch.ones((b, max_new_tokens), dtype=torch.bool,
                                                       device=eng.device)], dim=1)
        return eng._decode(hidden[:, -1], positions[:, -1], kc, vc, s, kv_valid,
                           max_new_tokens, temperature, eos_id, pad_id, seed, top_p, top_k)

    @torch.inference_mode()
    def next_token_logits(self, prompts: Sequence[Sequence[int]], pixel_values,
                          pad_id: int = 0, bucket: int = 16) -> np.ndarray:
        """Image-conditioned prefill-only float32 logits ``[B, V]``
        (engine.py:802-836, gemma3_mm.py:269-291), the constrained-decoding
        surface."""
        eng = self.lm
        s, ids, mask = self._padded(prompts, pad_id, bucket)
        kc, vc = eng._caches(len(prompts), s)
        hidden, _, _ = self.prefill(ids, mask, self._pixels(pixel_values), kc, vc)
        return eng._logits(eng.params, hidden[:, -1]).cpu().numpy()


class PaliGemmaEngine(_ImageEngine):
    """Image-conditioned generation on the ColPali / PaliGemma weights
    (engine.py:649-850).

    A ColPali retriever already holds the whole PaliGemma stack (SigLIP
    tower, projector, Gemma LM). This engine runs the retriever's own tower
    and projector modules (no copy of their weights; the tower's attention
    is K2 on a CUDA tensor) and decodes through ``lm``, the
    ``GemmaDecodeEngine`` that serves text beside it over the same weights
    (its tree is shared, quantized or not; build it from
    ``convert.engine_params_from_state_dict(model.state_dict())``). Page images
    lead the prompt (:meth:`build_mm_prompt`); the prompt attends
    bidirectionally, generated tokens causally, and positions are 1-indexed,
    as in HF PaliGemma."""

    # a bidirectional prompt shares no prefix pages, since each page's K/V
    # depend on the whole prompt
    first_position = 1
    shares_prefix_pages = False

    def __init__(self, model: Any, lm: GemmaDecodeEngine):
        self.cfg = model.cfg
        self.vision_tower = model.vision_tower
        self.projector = model.multi_modal_projector
        self.lm = lm

    def _project(self, vis: torch.Tensor, b: int) -> torch.Tensor:
        """Patches -> the projected features of each row's images ``[B, N * P, text]``."""
        return self.projector(vis.reshape(b, -1, vis.shape[-1]))

    def _merge(self, ids: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """Token embeddings with the projected features ``img`` in the
        ``<image>`` slots, image after image (engine.py:672-709)."""
        c, eng = self.cfg, self.lm
        is_img = ids == c.image_token_id
        embeds = q_take(eng.params["embed"]["embed_tokens"],
                        torch.where(is_img, torch.zeros_like(ids), ids), eng.dtype)
        img = img / torch.tensor(c.text.hidden_size ** 0.5, dtype=img.dtype, device=img.device)
        img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, img.shape[1] - 1)
        gathered = torch.gather(img, 1, img_pos[..., None].expand(-1, -1, img.shape[-1]))
        embeds = torch.where(is_img[..., None], gathered, embeds)
        return (embeds.float() * c.text.hidden_size ** 0.5).to(eng.dtype)

    def _prefill_embeds(self, ids: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, kc, vc):
        """The bidirectional prompt ``ids``/``mask [B, s]`` with embeddings
        ``x`` into the caches' first ``s`` rows -> (hidden, (k, v), 1-indexed
        positions)."""
        eng = self.lm
        positions = torch.cumsum(mask, dim=1)
        t = kc[0].shape[1]
        valid = torch.zeros((ids.shape[0], t), dtype=torch.bool, device=eng.device)
        valid[:, :ids.shape[1]] = mask.bool()
        hidden, kv = eng._chunk(eng.params, x, positions, kc, vc, 0, valid, causal=False)
        return hidden, kv, positions

    def build_mm_prompt(self, text_ids: Sequence[int], bos_id: int = 2,
                        newline_ids: Sequence[int] = (), n_images: int = 1) -> List[int]:
        """PaliGemma's layout (engine.py:838-850): the image tokens of every
        image in order, then bos, the text and the prefix's closing newline
        (its ids, or part of ``text_ids``)."""
        c = self.cfg
        return ([c.image_token_id] * (c.vision.num_patches * max(1, n_images))
                + [bos_id] + list(text_ids) + list(newline_ids))


def _detect_quantized_dtype(lm_tree: Any) -> str:
    """"int4" / "int8" / "native" from the first kernel dict found (engine.py:47-66)."""
    if isinstance(lm_tree, dict):
        if "q4" in lm_tree:
            return "int4"
        if "q8" in lm_tree:
            return "int8"
        for v in lm_tree.values():
            found = _detect_quantized_dtype(v)
            if found != "native":
                return found
    return "native"


class ByteTokenizer:
    """Reversible UTF-8 byte tokenizer (ids 0..255, then pad/bos/eos)."""

    def __init__(self):
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_special_tokens else ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")


class ModuloTokenizer:
    """Byte tokenizer folded into a model vocab (random-weight serving and
    tests): ids land in [2, vocab - 6); decode is the id listing. The top ids
    stay unused, as in the JAX package (engine.py:875-898)."""

    def __init__(self, vocab_size: int):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = -1  # random LMs have no meaningful eos
        self.vocab_size = vocab_size
        self._span = max(vocab_size - 8, 1)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [2 + (b % self._span) for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_special_tokens else ids

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(str(i) for i in ids)
