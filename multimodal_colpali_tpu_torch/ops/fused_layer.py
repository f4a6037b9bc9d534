"""Fused pre-LN SigLIP encoder layer (counterpart of ``multimodal_colpali_tpu/ops/fused_layer.py``).

    y = x2 + fc2(gelu_tanh(fc1(LN2(x2)))),   x2 = x + out_proj(MHA(LN1(x)))

Three functions per TPU kernel:

- the plain PyTorch versions :func:`fused_vit_layer_reference`,
  :func:`fused_vit_attention_block_reference` and
  :func:`fused_mlp_block_reference`, with the TPU kernels' rounding points
  (fused_layer.py:154-158, :285-322): LayerNorm in float32 then the
  activation dtype, each dense with float32 accumulation and a float32 bias
  then the activation dtype, gelu_tanh on the rounded fc1 output, residual
  adds in the activation dtype;
- the kernel wrappers K5a :func:`fused_vit_layer_cuda`, K5b
  :func:`fused_vit_attention_block_cuda` and K5c :func:`fused_mlp_block_cuda`;
- the dispatchers :func:`fused_vit_layer`, :func:`fused_vit_attention_block`
  and :func:`fused_mlp_block`: a CPU tensor takes the plain version, a CUDA
  tensor the kernel, with no fallback between them.

A whole layer does not fit an SM's shared memory the way it fits a TPU
core's VMEM, so on the card each wrapper is a short chain of launches
(:func:`attention_chain`, :func:`mlp_chain`) of the GEMM in
``csrc/fused_layer.cu``, :func:`fused_gemm_cuda` (LayerNorm prologue;
bias, bias + gelu_tanh or bias + residual epilogue), and of K2
(``ops/attention.py``): K5a = LN1·QKV, K2, out_proj + residual, LN2·fc1 +
gelu, fc2 + residual; K5b = LN1·QKV, K2, out_proj + residual; K5c =
LN2·fc1 + gelu, fc2 + residual. No LayerNorm output is written to device
memory. The GEMM takes bf16 activations on the tensor cores (wgmma fed by
TMA, tiles from :func:`gemm_plan`, the row statistics from one
:func:`ln_stats_cuda` launch before each LN GEMM) and float32 ones (a model
run in float32) on the CUDA cores; any other dtype raises. Its plain
version at its own contract is :func:`gemm_reference`.

Weights are in torch layout (``[out, in]``, the transpose of the flax
``kernel``), as the port's ``Dense`` modules hold them. ``layer_plan`` is
the JAX package's applicability gate, copied as it is so that the same
models take the fused path (``models/layers.py``): its VMEM estimate is a
TPU figure (SigLIP-768 admitted, SigLIP-So400m refused).
``attention_block_plan`` and ``mlp_block_plan`` pick the TPU kernels' tile
rows; nothing in the port reads them, and they exist only so that a test
holds them equal to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad
from multimodal_colpali_tpu_torch.ops.attention import attention_reference, fused_attention_cuda

_VMEM_BUDGET = 14 * 1024 * 1024
_LAYER_VMEM_CEILING = 64 * 1024 * 1024
_LAYER_VMEM_LIMIT = 100 * 1024 * 1024

# csrc/fused_layer.cu epilogue and activation-dtype codes
_EPI_BIAS, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LayerPlan(NamedTuple):
    vmem_limit: int


class AttnBlockPlan(NamedTuple):
    bq: int


class MlpBlockPlan(NamedTuple):
    bm: int


def layer_plan(s: int, h: int, inter: int, heads: int,
               dtype_bytes: int = 2) -> Optional[LayerPlan]:
    """The whole-layer kernel's applicability gate (fused_layer.py:69-97):
    a TPU VMEM estimate, or None when over the ceiling."""
    if h % heads or s % 128 or h % 128:
        return None
    db = dtype_bytes
    weights = 4 * h * h * db + 2 * h * inter * db
    io = 4 * s * h * db
    attn_peak = (s * h * 4 + 4 * s * h * db + 2 * s * s * 4 + s * h * db
                 + s * h * 4 + 2 * s * h * db)
    mlp_peak = (s * h * 4 + 2 * s * h * db + s * inter * 4 + s * inter * db
                + s * h * 4)
    if weights + io + max(attn_peak, mlp_peak) > _LAYER_VMEM_CEILING:
        return None
    return LayerPlan(vmem_limit=_LAYER_VMEM_LIMIT)


def attention_block_plan(s: int, h: int, heads: int,
                         dtype_bytes: int = 2) -> Optional[AttnBlockPlan]:
    """The attention-block kernel's gate (fused_layer.py:108-137)."""
    if h % heads or s % 128 or h % 128:
        return None
    fixed = 2 * s * h * dtype_bytes + 3 * h * h * dtype_bytes + 2 * s * h * dtype_bytes
    for bq in (256, 128):
        if s % bq:
            continue
        need = fixed + 2 * bq * h * dtype_bytes + (3 * bq * s * 4) // 2 + 2 * bq * h * 4
        if need <= _VMEM_BUDGET:
            return AttnBlockPlan(bq=bq)
    return None


def mlp_block_plan(h: int, inter: int, dtype_bytes: int = 2) -> Optional[MlpBlockPlan]:
    """The MLP-block kernel's gate (fused_layer.py:140-151)."""
    fixed = 2 * h * inter * dtype_bytes
    for bm in (256, 128):
        need = (fixed + 4 * bm * h * dtype_bytes + bm * inter * 4
                + bm * inter * dtype_bytes + 2 * bm * h * 4)
        if need <= _VMEM_BUDGET:
            return MlpBlockPlan(bm=bm)
    return None


# -- plain versions -------------------------------------------------------------

def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` in float32 on the activation's values, cast back."""
    return (x.float() @ w.float().t() + b.float()).to(x.dtype)


def _attention_reference(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, heads, eps):
    b, s, h = x.shape
    xn = _layernorm(x, ln_g, ln_b, eps)
    shape = (b, s, heads, h // heads)
    q, k, v = (_dense(xn, w, bias).view(shape) for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    return attention_reference(q, k, v, scale=(h // heads) ** -0.5).reshape(b, s, h)


def fused_vit_attention_block_reference(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                        *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """``x + out_proj(MHA(LN1(x)))`` for ``x [B, S, H]``, plain PyTorch."""
    attn = _attention_reference(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, heads, eps)
    return x + _dense(attn, wo, bo)


def fused_mlp_block_reference(x, ln_g, ln_b, w1, b1, w2, b2,
                              *, eps: float = 1e-6) -> torch.Tensor:
    """``x + fc2(gelu_tanh(fc1(LN2(x))))`` over the last axis, plain PyTorch."""
    hid = F.gelu(_dense(_layernorm(x, ln_g, ln_b, eps), w1, b1), approximate="tanh")
    return x + _dense(hid, w2, b2)


def fused_vit_layer_reference(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                              ln2_g, ln2_b, w1, b1, w2, b2,
                              *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """One pre-LN SigLIP encoder layer on ``x [B, S, H]``, plain PyTorch."""
    x2 = fused_vit_attention_block_reference(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                             heads=heads, eps=eps)
    return fused_mlp_block_reference(x2, ln2_g, ln2_b, w1, b1, w2, b2, eps=eps)


# -- the GEMM and its plain version -----------------------------------------------------

GEMM_EPILOGUES = {"bias": _EPI_BIAS, "gelu": _EPI_GELU, "residual": _EPI_RESIDUAL}
# the four GEMMs of a layer, each counted apart by fused_gemm_cuda
GEMM_ROLES = ("qkv", "out_proj", "fc1", "fc2")
GEMM_BM = 128          # rows of a bf16 tile: two warpgroups of 64
_TILE_COST = 32        # a tile's fixed cost (fill, epilogue), in columns of products


class GemmPlan(NamedTuple):
    bn: int      # output columns a tile: 128 or 256
    tiles: int   # row tiles x column tiles a segment x segments
    grid: int    # persistent blocks, each walking tiles grid apart


def gemm_plan(m: int, nseg: int, segs: int, sms: int) -> GemmPlan:
    """The bf16 GEMM's tiles from the shapes alone: ``m`` rows, ``segs``
    weight segments of ``nseg`` columns, ``sms`` multiprocessors.

    A tile is ``GEMM_BM`` rows by ``bn`` columns of one segment (a segment's
    last tile may be partial, never shared with the next segment). The width
    is the one whose waves (tiles over ``sms``, rounded up) times its cost,
    ``bn + _TILE_COST``, are least, 256 on a tie: wider tiles read less of
    A and W a product but quantize the last wave more coarsely."""
    def plan(w):
        tiles = -(-m // GEMM_BM) * -(-nseg // w) * segs
        return GemmPlan(bn=w, tiles=tiles, grid=min(tiles, sms))

    return min((plan(w) for w in (256, 128)),
               key=lambda p: -(-p.tiles // sms) * (p.bn + _TILE_COST))


def gemm_tiles(plan: GemmPlan, m: int, nseg: int, segs: int):
    """Tile ``t`` of ``plan`` as the kernel decodes it: ``(m0, seg, n0)``,
    rows ``m0 .. m0 + 127`` of segment ``seg``'s columns ``n0 .. n0 + bn -
    1``. Column tiles vary fastest (the blocks in flight share A's rows)."""
    n_tiles = -(-nseg // plan.bn)
    for t in range(plan.tiles):
        nt = t % (n_tiles * segs)
        yield t // (n_tiles * segs) * GEMM_BM, nt // n_tiles, (nt % n_tiles) * plan.bn


def ln_stats_reference(a: torch.Tensor, eps: float) -> torch.Tensor:
    """``[M, 2]`` float32: each row's mean and ``1 / sqrt(var + eps)`` (the
    mean squared deviation, as jnp.var), in float32."""
    x = a.float()
    mean = x.mean(-1)
    var = (x - mean[:, None]).square().mean(-1)
    return torch.stack([mean, 1.0 / torch.sqrt(var + eps)], dim=-1)


def gemm_reference(a: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor], epilogue: str, ln: Optional[tuple] = None,
                   eps: float = 0.0, resid: Optional[torch.Tensor] = None,
                   role: Optional[str] = None) -> torch.Tensor:
    """The GEMM's plain version: ``epilogue(LN?(a) @ w.T + bias)`` for each
    weight, stacked as ``[len(weights), M, Nseg]`` in ``a``'s dtype, with
    the rounding points of the fused references (``ln`` = (weight, bias) of
    the LayerNorm; ``epilogue`` "bias", "gelu" or "residual", the last adding
    ``resid [M, Nseg]``). ``role`` is the kernel wrapper's counter; unused."""
    x = a if ln is None else _layernorm(a, ln[0], ln[1], eps)
    outs = []
    for w, bias in zip(weights, biases):
        y = _dense(x, w, bias)
        if epilogue == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif epilogue == "residual":
            y = resid + y
        outs.append(y)
    return torch.stack(outs)


# -- kernels ----------------------------------------------------------------------

def _vec(v: torch.Tensor, n: int, dev: torch.device, what: str) -> torch.Tensor:
    if v.shape != (n,):
        raise ValueError(f"{what} must have shape ({n},), got {tuple(v.shape)}")
    t = v.to(device=dev, dtype=torch.float32).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


_SMS: dict = {}


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def ln_stats_cuda(a: torch.Tensor, eps: float) -> torch.Tensor:
    """``csrc/fused_layer.cu`` ``ln_stats_kernel``: :func:`ln_stats_reference`
    of ``a [M, K]`` bf16 on the card, a warp a row. Adds one to
    ``.launches`` per call."""
    refuse_grad("ln_stats_cuda", a)
    if not a.is_cuda or a.dtype != torch.bfloat16 or a.dim() != 2:
        raise ValueError(f"ln_stats_cuda takes a CUDA bf16 [M, K], got {a.dtype} "
                         f"{tuple(a.shape)} on {a.device}")
    m, k = a.shape
    a = a.contiguous()
    if k % 8 or a.data_ptr() % 16:
        raise ValueError(f"ln_stats_cuda needs K % 8 == 0 and a 16-byte aligned row start, "
                         f"got K={k}")
    stats = torch.empty((m, 2), dtype=torch.float32, device=a.device)
    lib = _build.load("fused_layer")
    code = lib.ln_stats_launch(a.data_ptr(), stats.data_ptr(), m, k, float(eps),
                               torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, "ln_stats_launch")
    ln_stats_cuda.launches += 1
    return stats


def fused_gemm_cuda(a: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], epilogue: str, ln: Optional[tuple] = None,
                    eps: float = 0.0, resid: Optional[torch.Tensor] = None,
                    role: Optional[str] = None) -> torch.Tensor:
    """``csrc/fused_layer.cu``: :func:`gemm_reference` on the card.

    ``a [M, K]`` bf16 or float32; each weight ``[Nseg, K]`` in ``a``'s
    dtype; returns ``[len(weights), M, Nseg]`` in that dtype, one plane per
    weight. bf16 runs ``gemm_wgmma`` on :func:`gemm_plan`'s tiles, after
    :func:`ln_stats_cuda` when there is a LayerNorm; float32 runs the
    CUDA-core ``gemm_f32_kernel``. Adds one to ``.launches`` per call, to
    ``.wgmma_launches`` or ``.cuda_core_launches`` by the path, and to
    ``.<role>_launches`` for a ``role`` of ``GEMM_ROLES``."""
    return _gemm_launch(a, weights, biases, epilogue, ln, eps, resid, role)


def _gemm_launch(a, weights, biases, epilogue, ln=None, eps=0.0, resid=None, role=None,
                 lib=None):
    """One call of :func:`fused_gemm_cuda`, counted on it; ``lib`` (default
    the package's build) is for ``fused_gemm_sweep``'s probe builds."""
    refuse_grad("fused_gemm_cuda", a, *weights, *biases, *(ln or ()), resid)
    if not a.is_cuda:
        raise ValueError("fused_gemm_cuda needs a CUDA tensor")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_gemm_cuda takes bf16 or float32, got {a.dtype}")
    if epilogue not in GEMM_EPILOGUES or role not in (None, *GEMM_ROLES):
        raise ValueError(f"unknown epilogue {epilogue!r} or role {role!r}")
    m, k = a.shape
    dev = a.device
    nseg = weights[0].shape[0]
    if not 1 <= len(weights) <= 3 or len(biases) != len(weights):
        raise ValueError(f"1 to 3 weights with a bias each, got {len(weights)} and "
                         f"{len(biases)}")
    for i, w in enumerate(weights):
        if w.shape != (nseg, k):
            raise ValueError(f"weight {i} must be [{nseg}, {k}], got {tuple(w.shape)}")
        if w.device != dev or w.dtype != a.dtype:
            raise TypeError(f"weight {i} must be {a.dtype} on {dev}, got {w.dtype} on "
                            f"{w.device}")
    if k % 8 or nseg % 8:
        raise ValueError(f"the GEMM takes K and N in multiples of 8, got K={k}, N={nseg}")
    if (epilogue == "residual") != (resid is not None) or (
            resid is not None and (resid.shape != (m, nseg) or len(weights) != 1)):
        raise ValueError("the residual epilogue takes one weight and resid [M, Nseg]")
    a = a.contiguous()
    ws = [w.contiguous() for w in weights]
    bs = [_vec(bias, nseg, dev, f"bias {i}") for i, bias in enumerate(biases)]
    g, b = (None, None) if ln is None else (_vec(ln[0], k, dev, "LN weight"),
                                            _vec(ln[1], k, dev, "LN bias"))
    resid = None if resid is None else resid.contiguous()
    out = torch.empty((len(ws), m, nseg), dtype=a.dtype, device=dev)
    for t in (a, *ws, out) + (() if resid is None else (resid,)):
        if t.data_ptr() % 16:
            raise ValueError("the GEMM needs 16-byte aligned tensors")
    bf16 = a.dtype == torch.bfloat16
    plan = gemm_plan(m, nseg, len(ws), _sms(dev)) if bf16 else None
    stats = ln_stats_cuda(a, eps) if bf16 and ln is not None else None
    ws += [ws[0]] * (3 - len(ws))
    bs += [bs[0]] * (3 - len(bs))
    lib = lib or _build.load("fused_layer")
    code = lib.gemm_launch(
        a.data_ptr(), None if stats is None else stats.data_ptr(),
        None if g is None else g.data_ptr(), None if b is None else b.data_ptr(), float(eps),
        *(w.data_ptr() for w in ws), *(v.data_ptr() for v in bs),
        None if resid is None else resid.data_ptr(), out.data_ptr(),
        m, nseg * len(weights), k, nseg, GEMM_EPILOGUES[epilogue], _DTYPE_CODES[a.dtype],
        plan.bn if bf16 else 0, plan.grid if bf16 else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "gemm_launch")
    fused_gemm_cuda.launches += 1
    if bf16:
        fused_gemm_cuda.wgmma_launches += 1
    else:
        fused_gemm_cuda.cuda_core_launches += 1
    if role is not None:
        setattr(fused_gemm_cuda, f"{role}_launches",
                getattr(fused_gemm_cuda, f"{role}_launches") + 1)
    return out


ln_stats_cuda.launches = 0
fused_gemm_cuda.launches = fused_gemm_cuda.wgmma_launches = fused_gemm_cuda.cuda_core_launches = 0
for _role in GEMM_ROLES:
    setattr(fused_gemm_cuda, f"{_role}_launches", 0)


def _check_x(x: torch.Tensor, what: str) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes bf16 or float32 activations, got {x.dtype}")
    return x.contiguous()


# The launch chains, over a GEMM and an attention: the kernels' on the card
# (fused_gemm_cuda, fused_attention_cuda); the plain versions' in the tests,
# where they equal the fused references bit for bit.

def attention_chain(gemm, attend, x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
    """``x + out_proj(MHA(LN1(x)))`` on ``x [B, S, H]``: LN1·QKV as one
    GEMM of three segments (q, k, v planes), ``attend``, out_proj +
    residual."""
    b, s, h = x.shape
    if h % heads:
        raise ValueError(f"hidden {h} is not a multiple of {heads} heads")
    x2d = x.reshape(b * s, h)
    qkv = gemm(x2d, (wq, wk, wv), (bq, bk, bv), "bias", ln=(ln_g, ln_b), eps=eps, role="qkv")
    shape = (b, s, heads, h // heads)
    attn = attend(qkv[0].view(shape), qkv[1].view(shape), qkv[2].view(shape),
                  scale=(h // heads) ** -0.5)
    out = gemm(attn.reshape(b * s, h), (wo,), (bo,), "residual", resid=x2d, role="out_proj")
    return out[0].view(b, s, h)


def mlp_chain(gemm, x, ln_g, ln_b, w1, b1, w2, b2, eps):
    """``x + fc2(gelu_tanh(fc1(LN2(x))))`` over the last axis: LN2·fc1 +
    gelu, then fc2 + residual."""
    h = x.shape[-1]
    x2d = x.reshape(-1, h)
    hid = gemm(x2d, (w1,), (b1,), "gelu", ln=(ln_g, ln_b), eps=eps, role="fc1")[0]
    return gemm(hid, (w2,), (b2,), "residual", resid=x2d, role="fc2")[0].view(x.shape)


def _attention_block_cuda(x, *params):
    return attention_chain(fused_gemm_cuda, fused_attention_cuda, x, *params)


def _mlp_block_cuda(x, *params):
    return mlp_chain(fused_gemm_cuda, x, *params)


def fused_vit_attention_block_cuda(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                   *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """K5b on the card: LN1·QKV and K2, then out_proj + residual, on
    ``x [B, S, H]`` (bf16 or float32, the weights in the same dtype). Adds one to ``.launches`` per call."""
    refuse_grad("fused_vit_attention_block_cuda", x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)
    x = _check_x(x, "fused_vit_attention_block_cuda")
    if x.dim() != 3:
        raise ValueError(f"expected [B, S, H], got {tuple(x.shape)}")
    y = _attention_block_cuda(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps)
    fused_vit_attention_block_cuda.launches += 1
    return y


def fused_mlp_block_cuda(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-6) -> torch.Tensor:
    """K5c on the card: LN2·fc1 + gelu_tanh, then fc2 + residual, over the
    last axis of ``x`` (bf16 or float32). Adds one to ``.launches`` per call."""
    refuse_grad("fused_mlp_block_cuda", x, ln_g, ln_b, w1, b1, w2, b2)
    x = _check_x(x, "fused_mlp_block_cuda")
    y = _mlp_block_cuda(x, ln_g, ln_b, w1, b1, w2, b2, eps)
    fused_mlp_block_cuda.launches += 1
    return y


def fused_vit_layer_cuda(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                         ln2_g, ln2_b, w1, b1, w2, b2,
                         *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """K5a on the card: a whole pre-LN SigLIP layer on ``x [B, S, H]``
    as four GEMMs and K2 (LN1·QKV, K2, out_proj + residual, LN2·fc1 + gelu,
    fc2 + residual; bf16 adds a LayerNorm statistics launch before each LN
    GEMM). Adds one to ``.launches`` per call."""
    refuse_grad("fused_vit_layer_cuda", x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                ln2_g, ln2_b, w1, b1, w2, b2)
    x = _check_x(x, "fused_vit_layer_cuda")
    if x.dim() != 3:
        raise ValueError(f"expected [B, S, H], got {tuple(x.shape)}")
    x2 = _attention_block_cuda(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps)
    y = _mlp_block_cuda(x2, ln2_g, ln2_b, w1, b1, w2, b2, eps)
    fused_vit_layer_cuda.launches += 1
    return y


fused_vit_layer_cuda.launches = 0
fused_vit_attention_block_cuda.launches = 0
fused_mlp_block_cuda.launches = 0


# -- dispatchers ----------------------------------------------------------------------

def _pick(x: torch.Tensor, kernel, plain, name: str):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: unsupported device {x.device}")


def fused_vit_layer(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_g, ln2_b,
                    w1, b1, w2, b2, *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """One pre-LN SigLIP encoder layer (fused_layer.py:326-392 semantics):
    K5a for a CUDA tensor, the plain version for a CPU tensor."""
    fn = _pick(x, fused_vit_layer_cuda, fused_vit_layer_reference, "fused_vit_layer")
    return fn(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_g, ln2_b, w1, b1, w2, b2,
              heads=heads, eps=eps)


def fused_vit_attention_block(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                              *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """``x + out_proj(MHA(LN1(x)))`` (fused_layer.py:218-273 semantics):
    K5b for a CUDA tensor, the plain version for a CPU tensor."""
    fn = _pick(x, fused_vit_attention_block_cuda, fused_vit_attention_block_reference,
               "fused_vit_attention_block")
    return fn(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads, eps=eps)


def fused_mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-6) -> torch.Tensor:
    """``x + fc2(gelu_tanh(fc1(LN2(x))))`` (fused_layer.py:413-464 semantics):
    K5c for a CUDA tensor, the plain version for a CPU tensor."""
    fn = _pick(x, fused_mlp_block_cuda, fused_mlp_block_reference, "fused_mlp_block")
    return fn(x, ln_g, ln_b, w1, b1, w2, b2, eps=eps)
