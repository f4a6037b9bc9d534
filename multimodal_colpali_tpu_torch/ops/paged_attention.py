"""Paged-KV decode attention (counterpart of
``multimodal_colpali_tpu/ops/paged_attention.py``).

Layout, the JAX package's:

  k_pool / v_pool : [P, page, Hkv, D]   physical pages shared by the slots
  block_tables    : [B, NB] int32       logical block i of slot b lives in
                                        physical page block_tables[b, i]
  lengths         : [B] int32           tokens held by each slot

Token t of slot b sits at (page block_tables[b, t // page], row t % page).
One decode token per slot attends positions ``< lengths[b]`` (and, with
``window > 0``, ``>= lengths[b] - window``: Gemma-3's sliding layers).

- :func:`paged_attention_reference` - the plain version, the JAX package's
  ``paged_attention_xla`` (paged_attention.py:57-90): gather each slot's
  logical view and run a float32-softmax attention. A slot of length 0 gets
  the uniform mean of all its ``NB * page`` gathered V rows.
- :func:`paged_attention_cuda` - K7a (``csrc/paged_attention.cu``), which
  replaces the TPU kernel ``_paged_kernel``: an mma.sync path for bf16
  (:func:`tensor_core_path`) and a CUDA-core path for the rest, both split
  over each slot's tokens by :func:`split_plan`, which reads shapes only.
- :func:`paged_attention` - the dispatcher: CPU tensors take the plain
  version, CUDA tensors the kernel.

and for int8 pools (codes plus one float32 absmax scale per token and kv
head, made by :func:`quantize_kv_rows`): :func:`paged_attention_int8_reference`
(dequantize first, ``paged_attention_int8_xla``, :217-233),
:func:`paged_attention_int8_cuda` (K7b, replacing ``_paged_kernel_int8``:
scales applied after the dots, so it agrees with the plain version to bf16
rounding, not bit for bit) and :func:`paged_attention_int8`.
"""

from __future__ import annotations

import functools

import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad

NEG = -1e30
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_GROUP_DIM = 4096   # (q heads per kv head) * head_dim a block's threads hold
_MAX_TC_DIM, _MAX_TC_GROUP = 256, 16   # the tensor-core path's largest D and group
STEP = 16               # tokens of a split step (csrc/paged_attention.cu kStep)
WAVES = 2               # blocks the plan puts on an SM (see split_plan)
MAX_BLOCK_TOKENS = 1024  # the longest walk the plan leaves a block of a full slot


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                              block_tables: torch.Tensor, lengths: torch.Tensor, *,
                              scale: float, window: int = 0) -> torch.Tensor:
    """Gather-based paged attention: q ``[B, Hq, D]`` -> ``[B, Hq, D]``."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, nb * page, hkv, d)
    v = v_pool[bt].reshape(b, nb * page, hkv, d)
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    pos = torch.arange(nb * page, device=q.device)[None, None, :]
    lens = lengths.to(q.device).long()[:, None, None]
    valid = pos < lens
    if window:
        valid = valid & (pos >= lens - window)
    logits = logits.masked_fill(~valid, NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def quantize_kv_rows(x: torch.Tensor):
    """Per-(token, head) absmax int8 quantization of KV rows
    (paged_attention.py:205-214): ``x [..., Hkv, D]`` -> (codes int8 of the
    same shape, scales float32 ``[..., Hkv]``), bit for bit the JAX
    package's. Dequantization is ``codes * scales[..., None]``."""
    xf = x.float()
    # Tensor divisors: CUDA divides by a Python scalar through its reciprocal.
    s = xf.abs().amax(dim=-1)
    s = s / torch.full_like(s, 127.0)
    safe = torch.maximum(s, torch.full_like(s, 1e-12))[..., None]
    return torch.round(xf / safe).to(torch.int8), s


def paged_attention_int8_reference(q: torch.Tensor, k_pool: torch.Tensor, k_scale: torch.Tensor,
                                   v_pool: torch.Tensor, v_scale: torch.Tensor,
                                   block_tables: torch.Tensor, lengths: torch.Tensor, *,
                                   scale: float, window: int = 0) -> torch.Tensor:
    """Dequantize the pools to q's type, then :func:`paged_attention_reference`."""
    kd = (k_pool.float() * k_scale[..., None]).to(q.dtype)
    vd = (v_pool.float() * v_scale[..., None]).to(q.dtype)
    return paged_attention_reference(q, kd, vd, block_tables, lengths, scale=scale,
                                     window=window)


def split_plan(b: int, hkv: int, max_tokens: int, sm_count: int) -> int:
    """Blocks per (slot, kv head) of K7's launch, ``splits``: the launch has
    ``b * splits`` blocks a kv head, as many as one wave of ``WAVES`` blocks
    on each of the card's ``sm_count`` SMs holds (``b * hkv * splits <=
    WAVES * sm_count``), or more if a full slot's blocks would otherwise walk
    over ``MAX_BLOCK_TOKENS`` tokens each; never more than a slot's
    ``max_tokens`` (``NB * page``) has 16-token steps. A function of shapes
    only, never of ``lengths``, so that a CUDA graph can capture the launch;
    the kernel deals the blocks to the slots on the card (:func:`deal_cuda`
    reads that deal back). ``WAVES`` is the tensor-core path's occupancy at
    gemma-3-27b's D 128 with bf16 pools, the main path; the same plan serves
    the other paths and sizes (at D 256 one block fits an SM, so it runs in
    two waves there). On the card a second, partial wave cost more than it
    balanced at the decode step's shape, and long chains cost more at phase
    2's (PERF.md, section 6)."""
    steps = max(1, -(-max_tokens // STEP))
    wave = WAVES * sm_count // max(1, b * hkv)
    return max(1, min(steps, max(wave, -(-max_tokens // MAX_BLOCK_TOKENS)), 65535 // max(1, b)))


def tensor_core_path(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int, group: int) -> bool:
    """Whether K7 takes its mma.sync path: bf16 q over bf16 or int8 pools
    with D a multiple of 16 up to 256 and at most 16 q heads per kv head
    (gemma-3-27b, Gemma-1 2B). float32 and other shapes take the CUDA cores."""
    return (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and d % 16 == 0 and 16 <= d <= _MAX_TC_DIM and group <= _MAX_TC_GROUP)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def deal_cuda(lengths: torch.Tensor, *, window: int, total: int, splits: int) -> torch.Tensor:
    """How K7's kernels deal a kv head's ``B * splits`` blocks, read back from
    the card for tests: ``[B * splits, 3]`` int32 rows (slot, first token, end
    token) from the kernels' own device functions, for slots of ``lengths``
    tokens in a table of ``total`` (``NB * page``); a block whose first token
    is not below its end has none. Not a kernel of the path: counts nothing."""
    if not lengths.is_cuda or lengths.dim() != 1:
        raise ValueError("deal_cuda needs lengths [B] on a CUDA device")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(lens.numel() * splits, 3, dtype=torch.int32, device=lens.device)
    lib = _build.load("paged_attention")
    _build.check(lib, lib.paged_attention_deal(
        lens.data_ptr(), out.data_ptr(), lens.numel(), int(window), int(total), int(splits),
        torch.cuda.current_stream(lens.device).cuda_stream), "paged_attention_deal")
    return out


def _launch(wrapper, q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
            scale, window, splits=None, lib=None):
    """One launch of K7; ``splits`` (default :func:`split_plan`'s) and
    ``lib`` (default the package's build) are for ``generation.paged_sweep``."""
    name = wrapper.__name__
    tensors = [q, k_pool, v_pool, block_tables, lengths]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    refuse_grad(name, *tensors)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every input on one CUDA device")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: expected q [B, Hq, D] and pools [P, page, Hkv, D], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, hq, d = q.shape
    _, page, hkv, dk = k_pool.shape
    if dk != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools {tuple(k_pool.shape)}")
    if (hq // hkv) * d > _MAX_GROUP_DIM:
        raise ValueError(f"{name}: (Hq / Hkv) * D = {(hq // hkv) * d} > {_MAX_GROUP_DIM}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"{name}: block_tables must be [B, NB] and lengths [B], got "
                         f"{tuple(block_tables.shape)}, {tuple(lengths.shape)}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise TypeError(f"{name}: pools must have q's dtype {q.dtype}, got "
                            f"{k_pool.dtype}, {v_pool.dtype}")
    else:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"{name}: pools must be int8, got {k_pool.dtype}, {v_pool.dtype}")
        if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]:
            raise ValueError(f"{name}: scales must be [P, page, Hkv] = "
                             f"{tuple(k_pool.shape[:3])}")
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    nb = bt.shape[1]
    tensor_core = tensor_core_path(q.dtype, k_pool.dtype, d, hq // hkv)
    if splits is None:
        splits = split_plan(b, hkv, nb * page, _sm_count(q.device))
    partials = None
    if splits > 1:   # each split's (accumulator, max, sum) and the arrival counters
        partials = torch.empty(b * hq * splits * (d + 2) + b * hkv, dtype=torch.float32,
                               device=q.device)
    lib = lib or _build.load("paged_attention")
    code = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(), b, hq, hkv, d, page, nb,
        float(scale), int(window), splits, int(tensor_core), _Q_CODES[q.dtype],
        _KV_CODES[k_pool.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_attention_launch")
    wrapper.launches += 1
    if tensor_core:
        wrapper.tensor_core_launches += 1
    else:
        wrapper.cuda_core_launches += 1
    return out


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor, *,
                         scale: float, window: int = 0) -> torch.Tensor:
    """K7a on the card: float32 or bf16 q and pools of the same type. Adds
    one to ``paged_attention_cuda.launches`` per launch, and one to
    ``.tensor_core_launches`` or ``.cuda_core_launches`` by the path it took
    (:func:`tensor_core_path`)."""
    return _launch(paged_attention_cuda, q, k_pool, v_pool, None, None, block_tables,
                   lengths, scale, window)


paged_attention_cuda.launches = 0
paged_attention_cuda.tensor_core_launches = 0
paged_attention_cuda.cuda_core_launches = 0


def paged_attention_int8_cuda(q: torch.Tensor, k_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_pool: torch.Tensor, v_scale: torch.Tensor,
                              block_tables: torch.Tensor, lengths: torch.Tensor, *,
                              scale: float, window: int = 0) -> torch.Tensor:
    """K7b on the card: float32 or bf16 q over int8 pools with float32
    scales. Adds one to ``paged_attention_int8_cuda.launches`` per launch,
    and one to ``.tensor_core_launches`` (bf16 q) or ``.cuda_core_launches``."""
    return _launch(paged_attention_int8_cuda, q, k_pool, v_pool, k_scale, v_scale,
                   block_tables, lengths, scale, window)


paged_attention_int8_cuda.launches = 0
paged_attention_int8_cuda.tensor_core_launches = 0
paged_attention_int8_cuda.cuda_core_launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, *,
                    scale: float, window: int = 0) -> torch.Tensor:
    """Paged decode attention: K7a for a CUDA tensor, the plain version for a CPU one."""
    if q.device.type == "cuda":
        return paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                                    scale=scale, window=window)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                                         scale=scale, window=window)
    raise ValueError(f"paged_attention: unsupported device {q.device}")


def paged_attention_int8(q: torch.Tensor, k_pool: torch.Tensor, k_scale: torch.Tensor,
                         v_pool: torch.Tensor, v_scale: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor, *,
                         scale: float, window: int = 0) -> torch.Tensor:
    """Paged decode attention over int8 pools: K7b for a CUDA tensor, the
    plain version for a CPU one."""
    if q.device.type == "cuda":
        return paged_attention_int8_cuda(q, k_pool, k_scale, v_pool, v_scale, block_tables,
                                         lengths, scale=scale, window=window)
    if q.device.type == "cpu":
        return paged_attention_int8_reference(q, k_pool, k_scale, v_pool, v_scale,
                                              block_tables, lengths, scale=scale,
                                              window=window)
    raise ValueError(f"paged_attention_int8: unsupported device {q.device}")
