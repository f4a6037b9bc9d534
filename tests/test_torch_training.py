"""The port's training loop against the JAX package's, on the CPU.

``training/trainer`` (the ColBERT loss, AdamW with optax's defaults, the
train step with and without remat), ``training/checkpoint``,
``adamw_state_from_optax`` and K2's gradient (``attention_backward_reference``
and the ``_FusedAttention`` Function, whose CPU backward is the plain
version). Inputs and parameters come from numpy seeds; the JAX side runs its
einsum attention (the fused Pallas kernel has no reverse mode: fault F10).
Everything is float32, the JAX trainer's dtype, but the pins of fault F11
(bf16 and float16 gradients on the CPU, 3 bf16 AdamW steps against JAX's).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_colpali_tpu.models import layers as JL
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JCfg
from multimodal_colpali_tpu.models.registry import fast_random_params
from multimodal_colpali_tpu.training import trainer as JT
from multimodal_colpali_tpu_torch.models import convert
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.ops import attention as A
from multimodal_colpali_tpu_torch.ops import fused_layer as FL
from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
from multimodal_colpali_tpu_torch.ops import maxsim as M
from multimodal_colpali_tpu_torch.ops import paged_attention as PA
from multimodal_colpali_tpu_torch.ops import preprocess as PP
from multimodal_colpali_tpu_torch.ops import quant as Q
from multimodal_colpali_tpu_torch.ops import window_attention as WA
from multimodal_colpali_tpu_torch.training import (
    colbert_loss, make_train_step, make_training_setup)
from multimodal_colpali_tpu_torch.training.checkpoint import (
    make_checkpoint_manager, restore_train_state, save_train_state)
from multimodal_colpali_tpu_torch.training.trainer import adamw_state_from_optax

torch.set_num_threads(1)

LR = 1e-3        # JAX's test_train_step_reduces_loss
STEPS = 5


def _tiny_cfgs():
    """ColPali tiny with a 56-px SigLIP: 16 patches of 14 px, so the tower's
    attention runs over 16 tokens (the stock tiny config has 4)."""
    j, t = JCfg.tiny(), ColPaliModelConfig.tiny()
    return (dataclasses.replace(j, vision=dataclasses.replace(j.vision, image_size=56)),
            dataclasses.replace(t, vision=dataclasses.replace(t.vision, image_size=56)))


JCFG, TCFG = _tiny_cfgs()


def _batch(seed: int, b: int = 2):
    """numpy inputs: queries with trailing padding, pages of 16 image tokens
    and a 4-token prompt, the second page padded by 2."""
    rng = np.random.default_rng(seed)
    n_img = TCFG.vision.num_patches
    sd = n_img + 4
    q_mask = np.ones((b, 8), np.int32)
    q_mask[1, 5:] = 0
    d_ids = np.zeros((b, sd), np.int32)
    d_ids[:, :n_img] = TCFG.image_token_id
    d_ids[:, n_img:] = rng.integers(3, 60, (b, 4))
    d_mask = np.ones((b, sd), np.int32)
    d_mask[1, -2:] = 0
    return {
        "query_ids": rng.integers(3, 60, (b, 8)).astype(np.int32) * q_mask,
        "query_mask": q_mask,
        "doc_ids": d_ids,
        "doc_mask": d_mask,
        "doc_pixels": rng.uniform(-1, 1, (b, 56, 56, 3)).astype(np.float32),
    }


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) if v.dtype != np.int32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(jnp.asarray, fast_random_params(JColPali(JCFG), JCFG, 0))


def _port_model(jparams):
    model = ColPaliModel(TCFG, device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.params_from_flax(jparams, TCFG))
    return model


def _jax_loss_fn(batch):
    model = JColPali(JCFG)

    def loss_fn(params):
        q = model.apply({"params": params}, batch["query_ids"], batch["query_mask"], None)
        d = model.apply({"params": params}, batch["doc_ids"], batch["doc_mask"],
                        batch["doc_pixels"])
        return JT.colbert_loss(q, d, batch["query_mask"], batch["doc_mask"])

    return loss_fn


def _flat_grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _in_flax_layout(jtree):
    """A JAX tree -> ``{torch name: tensor}`` in the port's layout."""
    return convert.params_from_flax(jax.tree.map(np.asarray, jtree), TCFG)


# -- the ColBERT loss ---------------------------------------------------------------

def test_colbert_loss_matches_jax_value_and_grad():
    """Loss and both embedding gradients against ``jax.value_and_grad``,
    padded query and page tokens on both sides: loss rel 1e-6, gradients
    atol 1e-6 (float32 sums of 12 x 16 terms)."""
    rng = np.random.default_rng(0)
    b, nq, nt, dim = 3, 6, 9, 16
    q = rng.standard_normal((b, nq, dim)).astype(np.float32)
    d = rng.standard_normal((b, nt, dim)).astype(np.float32)
    q_mask = np.ones((b, nq), np.int32)
    q_mask[0, 4:] = 0
    q_mask[2, 1:] = 0
    d_mask = np.ones((b, nt), np.int32)
    d_mask[1, 5:] = 0
    d_mask[2, 2:] = 0
    q *= q_mask[..., None]
    d *= d_mask[..., None]
    want, (wq, wd) = jax.value_and_grad(JT.colbert_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(d), jnp.asarray(q_mask), jnp.asarray(d_mask))
    tq, td = (torch.from_numpy(x).requires_grad_() for x in (q, d))
    got = colbert_loss(tq, td, torch.from_numpy(q_mask), torch.from_numpy(d_mask))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(wq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


def test_colbert_loss_prefers_matched_pairs():
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.standard_normal((4, 5, 16)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    ones_q, ones_d = torch.ones(4, 3), torch.ones(4, 5)
    good = colbert_loss(d[:, :3], d, ones_q, ones_d)
    bad = colbert_loss(d[:, :3].roll(1, dims=0), d, ones_q, ones_d)
    assert float(good) < float(bad)


# -- K2's gradient ------------------------------------------------------------------

_MASKS = ["none", "kv_lens", "kv_valid", "causal", "masked_row"]


def _attn_case(case: str, dtype=np.float32):
    """q, k, v, dO ``[2, 12, 3, 8]`` and the case's masks (numpy). "masked_row":
    kv_valid drops key 0 of batch 0 under causal (its row 0 sees no key) and
    every key of batch 1."""
    rng = np.random.default_rng(_MASKS.index(case))
    q, k, v, g = (rng.standard_normal((2, 12, 3, 8)).astype(dtype) for _ in range(4))
    kv_lens = kv_valid = None
    causal = False
    if case == "kv_lens":
        kv_lens = np.array([12, 5], np.int32)
    elif case == "kv_valid":
        kv_valid = rng.integers(0, 2, (2, 12)).astype(bool)
        kv_valid[:, 0] = True
    elif case == "causal":
        causal = True
    elif case == "masked_row":
        kv_valid = np.ones((2, 12), bool)
        kv_valid[0, 0] = False
        kv_valid[1] = False
        causal = True
    return q, k, v, g, kv_lens, kv_valid, causal


def _opt(x, torch_dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t if torch_dtype is None else t.to(torch_dtype)


@pytest.mark.parametrize("case", _MASKS)
def test_attention_backward_reference_matches_jax_vjp(case):
    """dq, dk, dv of the plain version, and of the autograd Function on the
    CPU, against ``jax.vjp`` of JAX ``layers.attention`` (its einsum branch)
    at the same dO: atol 2e-6 (float32 sums over 12 keys of O(1) terms)."""
    q, k, v, g, kv_lens, kv_valid, causal = _attn_case(case)
    scale = 8 ** -0.5

    def jattn(q, k, v):
        return JL.attention(q, k, v, None, scale,
                            kv_lens=None if kv_lens is None else jnp.asarray(kv_lens),
                            causal=causal,
                            kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))

    jout, vjp = jax.vjp(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lens, valid = _opt(kv_lens), _opt(kv_valid)
    out = A.attention_reference(tq, tk, tv, None, lens, valid, scale=scale, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-6)
    got = A.attention_backward_reference(tq, tk, tv, out, torch.from_numpy(g), lens, valid,
                                         scale=scale, causal=causal)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=2e-6)
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    A.fused_attention(*xs, lens, valid, scale=scale, causal=causal).backward(torch.from_numpy(g))
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=0, atol=2e-6)


def test_fully_masked_row_sends_gradient_to_dv_only():
    """A query row that sees no key has uniform P: its dO reaches dV as
    P dO, and nothing reaches dQ (its own row) or, from it, dK."""
    q, k, v, g, kv_lens, kv_valid, causal = _attn_case("masked_row")
    g[0] = 0.0
    g[0, 0] = 1.0          # batch 0: only the fully masked row 0 has a gradient
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    valid = torch.from_numpy(kv_valid)
    out = A.attention_reference(tq, tk, tv, None, None, valid, scale=0.3, causal=True)
    dq, dk, dv = A.attention_backward_reference(tq, tk, tv, out, torch.from_numpy(g), None,
                                                valid, scale=0.3, causal=True)
    assert torch.equal(dq[0], torch.zeros_like(dq[0]))
    assert torch.equal(dk[0], torch.zeros_like(dk[0]))
    torch.testing.assert_close(dv[0], torch.from_numpy(g[0, 0])[None].expand(12, -1, -1) / 12)
    # batch 1: every key masked, every row uniform
    assert torch.equal(dq[1], torch.zeros_like(dq[1]))
    assert torch.equal(dk[1], torch.zeros_like(dk[1]))
    torch.testing.assert_close(dv[1], torch.from_numpy(g[1]).sum(0)[None].expand(12, -1, -1)
                               / 12)


@pytest.mark.parametrize("case", _MASKS)
def test_fused_attention_function_passes_gradcheck(case):
    """The Function's CPU backward (the plain version) against finite
    differences of its forward, in float64."""
    q, k, v, _, kv_lens, kv_valid, causal = _attn_case(case, np.float64)
    xs = [torch.from_numpy(x[:, :6]).requires_grad_() for x in (q, k, v)]
    lens = None if kv_lens is None else torch.from_numpy(np.minimum(kv_lens, 6))
    valid = None if kv_valid is None else torch.from_numpy(kv_valid[:, :6])
    assert torch.autograd.gradcheck(
        lambda q, k, v: A.fused_attention(q, k, v, lens, valid, scale=0.4, causal=causal),
        xs)


def test_fused_attention_without_grad_saves_nothing():
    """Inference stays as it was: no requires-grad input, or grad mode off,
    gives the plain forward with no graph."""
    x = torch.randn(1, 6, 2, 8)
    out = A.fused_attention(x, x, x, scale=0.3)
    assert out.grad_fn is None
    assert torch.equal(out, A.attention_reference(x, x, x, scale=0.3))
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert A.fused_attention(xg, xg, xg, scale=0.3).grad_fn is None
    assert A.fused_attention(xg, xg, xg, scale=0.3).grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_attention_refuses_grad_in_narrow_types(dtype):
    """On the CPU a bf16 or float16 call under grad no longer refuses (it
    did until fault F11 was fixed): it is autograd through the plain
    version, so its gradients equal those of ``attention_reference`` bit
    for bit, masks included. (On the card bf16 under grad still raises:
    tests/test_torch_cuda.py.)"""
    q, k, v, g, kv_lens, kv_valid, causal = _attn_case("masked_row")
    lens = torch.tensor([12, 7], dtype=torch.int32)
    valid = torch.from_numpy(kv_valid)
    grads = []
    for fn in (A.fused_attention, lambda *a, **kw: A.attention_reference(
            *a[:3], None, *a[3:], **kw)):
        xs = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
        out = fn(*xs, lens, valid, scale=0.3, causal=causal)
        assert out.dtype == dtype
        out.backward(torch.from_numpy(g).to(dtype))
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        assert torch.equal(got, want)


_W = torch.zeros(8, 8, dtype=torch.bfloat16)
_V = torch.zeros(8)
_POOL = torch.zeros(3, 4, 1, 8)
_BT, _LENS = torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)


def _g(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, requires_grad=True)


_NO_BACKWARD = {
    "attention": lambda: A.fused_attention_cuda(*(_g(1, 4, 2, 8),) * 3, scale=1.0),
    "attention_backward": lambda: A.fused_attention_backward_cuda(
        *(_g(1, 4, 2, 8),) * 5, scale=1.0),
    "maxsim": lambda: M.maxsim_scores_cuda(_g(1, 2, 8), torch.zeros(3, 4, 8)),
    "maxsim_int8": lambda: M.maxsim_scores_int8_cuda(
        _g(1, 2, 8), torch.zeros(3, 4, 8, dtype=torch.int8), torch.ones(3, 4)),
    "vit_layer": lambda: FL.fused_vit_layer_cuda(
        _g(1, 4, 8, dtype=torch.bfloat16), _V, _V, *(_W, _V) * 4, _V, _V, _W, _V, _W, _V,
        heads=2),
    "attn_block": lambda: FL.fused_vit_attention_block_cuda(
        torch.zeros(1, 4, 8, dtype=torch.bfloat16), _g(8), _V, *(_W, _V) * 4, heads=2),
    "mlp_block": lambda: FL.fused_mlp_block_cuda(
        torch.zeros(1, 4, 8, dtype=torch.bfloat16), _V, _V, _g(8, 8, dtype=torch.bfloat16),
        _V, _W, _V),
    "fused_gemm": lambda: FL.fused_gemm_cuda(_g(8, 8, dtype=torch.bfloat16), (_W,), (_V,),
                                             "bias"),
    "ln_stats": lambda: FL.ln_stats_cuda(_g(8, 8, dtype=torch.bfloat16), 1e-6),
    "window_attention": lambda: WA.window_attention_cuda(*(_g(3, 16, 8),) * 3, scale=1.0),
    "paged_attention": lambda: PA.paged_attention_cuda(_g(1, 2, 8), _POOL, _POOL, _BT, _LENS,
                                                       scale=1.0),
    "paged_attention_int8": lambda: PA.paged_attention_int8_cuda(
        _g(1, 2, 8), torch.zeros(3, 4, 1, 8, dtype=torch.int8), torch.ones(3, 4, 1),
        torch.zeros(3, 4, 1, 8, dtype=torch.int8), torch.ones(3, 4, 1), _BT, _LENS, scale=1.0),
    "int8_matmul_kn": lambda: IM.int8_matmul_kn_cuda(
        _g(8, 8, dtype=torch.bfloat16), torch.zeros(8, 4, dtype=torch.int8), torch.ones(4)),
    "int8_matmul_nk": lambda: IM.int8_matmul_nk_cuda(
        _g(8, 8, dtype=torch.bfloat16), torch.zeros(4, 8, dtype=torch.int8), torch.ones(4)),
    "int4_matmul_kn": lambda: I4.int4_matmul_kn_cuda(
        _g(8, 8, dtype=torch.bfloat16), torch.zeros(4, 4, dtype=torch.uint8), torch.ones(1, 4)),
    "w8a8_dense": lambda: Q.w8a8_dense(_g(2, 8), torch.zeros(4, 8, dtype=torch.int8),
                                       torch.ones(4)),
}


@pytest.mark.parametrize("name", sorted(_NO_BACKWARD))
def test_kernel_wrappers_without_backward_refuse_grad(name):
    """Each kernel wrapper but K2's Function raises under grad when an input
    requires grad, before it looks at the device (so on the CPU too), and
    launches nothing; under ``no_grad`` the same call gets past the guard
    (and, here, stops at the device check)."""
    counters = [getattr(f, "launches") for f in (
        A.fused_attention_cuda, A.fused_attention_backward_cuda, M.maxsim_scores_cuda,
        FL.fused_gemm_cuda, WA.window_attention_cuda, PA.paged_attention_cuda,
        IM.int8_matmul_kn_cuda, I4.int4_matmul_kn_cuda, PP.normalize_images_cuda)]
    with pytest.raises(NotImplementedError, match="has no backward"):
        _NO_BACKWARD[name]()
    with torch.no_grad():
        try:
            _NO_BACKWARD[name]()
        except (ValueError, TypeError, RuntimeError) as e:
            assert "has no backward" not in str(e)
    assert counters == [getattr(f, "launches") for f in (
        A.fused_attention_cuda, A.fused_attention_backward_cuda, M.maxsim_scores_cuda,
        FL.fused_gemm_cuda, WA.window_attention_cuda, PA.paged_attention_cuda,
        IM.int8_matmul_kn_cuda, I4.int4_matmul_kn_cuda, PP.normalize_images_cuda)]


def test_fused_attention_backward_cuda_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        A.fused_attention_backward_cuda(x, x, x, x, x, scale=1.0)


# -- the layers' switches -----------------------------------------------------------

def test_set_fused_attention_false_takes_the_einsum(monkeypatch):
    calls = []
    monkeypatch.setattr(L, "fused_attention", lambda *a, **kw: calls.append(1))
    x = torch.randn(1, 5, 2, 8)
    try:
        L.set_fused_attention(False)
        out = L.attention(x, x, x, None, 0.3)
        assert not calls
        assert torch.equal(out, A.attention_reference(x, x, x, scale=0.3))
        L.set_fused_attention(None)
        L.attention(x, x, x, None, 0.3)
        assert calls == [1]
    finally:
        L.set_fused_attention(None)


def test_models_load_frozen_and_the_trainer_thaws_them():
    model = ColPaliModel(ColPaliModelConfig.tiny(), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    make_training_setup(model)
    assert all(p.requires_grad for p in model.parameters())
    Q.quantize_encoder_params(model)
    L.set_trainable(model)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(model.get_parameter(n).dtype == torch.int8 for n in frozen)


# -- tiny ColPali against JAX's trainer ---------------------------------------------

def test_loss_and_every_gradient_match_jax(jparams):
    """The loss and the gradient of every leaf of tiny ColPali (56-px tower)
    against ``jax.value_and_grad`` of JAX's loss on the same parameters
    (``params_from_flax``): loss rel 1e-5; each gradient within 1e-5 of its
    leaf's largest element (float32 sums in another order through 4 layers:
    2e-6 seen) plus 1e-7, float32's rounding at gradients of order 1. The
    k-projection biases' true gradient is 0 (a constant added to a row's
    logits leaves its softmax unchanged): both packages return rounding
    noise of ~1e-8 there."""
    batch = _batch(0)
    want_loss, want = jax.value_and_grad(_jax_loss_fn(_jbatch(batch)))(jparams)
    model = _port_model(jparams)
    L.set_trainable(model)
    tb = _tbatch(batch)
    q = model(tb["query_ids"], tb["query_mask"], None)
    d = model(tb["doc_ids"], tb["doc_mask"], tb["doc_pixels"])
    loss = colbert_loss(q, d, tb["query_mask"], tb["doc_mask"])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want_t = _in_flax_layout(want)
    got = _flat_grads(model)
    assert set(got) == set(want_t)
    for name, g in got.items():
        w = want_t[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-7,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_run(jparams):
    """JAX's ``make_training_setup`` / ``make_train_step`` for STEPS steps
    at LR on batch 1: the losses and the parameters after each step."""
    model = JColPali(JCFG)
    params, opt_state, optimizer = JT.make_training_setup(model, jparams, learning_rate=LR)
    step = JT.make_train_step(model, optimizer)
    batch = _jbatch(_batch(1))
    losses, trees = [], []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        trees.append(params)
    return losses, trees


def _param_tolerance(steps: int):
    """An element's bound after ``steps`` AdamW steps where its gradient is
    rounding noise in both packages: Adam's first steps turn a gradient's
    sign into about +-lr, so such an element may differ by up to 2 lr a
    step."""
    return 2 * LR * steps


# the leaves whose true gradient is 0 (a constant added to every logit of a
# row leaves its softmax unchanged): both packages step them by rounding noise
NOISE_LEAVES = {f"vision_tower.layers.{i}.self_attn.k_proj.bias" for i in range(2)}


def _check_params(model, want_tree, steps: int):
    """Every parameter within 1e-5 of JAX's (float32 rounding through a few
    steps: 2e-7 seen at the 99th percentile), the noise leaves within
    ``_param_tolerance``."""
    want = _in_flax_layout(want_tree)
    for name, p in model.named_parameters():
        diff = float((p.detach() - want[name]).abs().max())
        bound = _param_tolerance(steps) if name in NOISE_LEAVES else 1e-5
        assert diff <= bound, (name, steps, diff)


def test_train_steps_match_jax(jparams, jax_run):
    """5 steps of the port's ``make_train_step`` against JAX's on the same
    batch: each loss rel 1e-5, and the parameters after each step as
    ``_check_params`` holds them."""
    want_losses, want_trees = jax_run
    model = _port_model(jparams)
    opt = make_training_setup(model, learning_rate=LR)
    step = make_train_step(model, opt)
    batch = _tbatch(_batch(1))
    for i in range(STEPS):
        loss = float(step(batch))
        assert loss == pytest.approx(want_losses[i], rel=1e-5), i
        _check_params(model, want_trees[i], i + 1)
    assert want_losses[-1] < want_losses[0]


def test_bf16_train_steps_match_jax(jparams):
    """Fault F11's pin: 3 AdamW steps of tiny ColPali in bf16 on the CPU
    (``fast_random_params(..., 0)`` cast to bf16 in both packages, bf16
    pixels) against JAX's ``make_train_step`` on the same batch: every loss
    within 0.02 of JAX's. bf16 keeps 8 significand bits, and the packages
    round at different points (XLA keeps float32 inside its fusions, torch
    rounds each op's output); Adam then turns a gradient's sign into a step
    of about lr, so the gap grows with the steps: 0.0021, 0.0075, 0.0087
    seen. Both runs' losses fall."""
    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    model_j = JColPali(JCFG)
    params, opt_state, optimizer = JT.make_training_setup(model_j, bf, learning_rate=LR)
    jstep = JT.make_train_step(model_j, optimizer)
    batch = _batch(1)
    jb = _jbatch(batch)
    jb["doc_pixels"] = jb["doc_pixels"].astype(jnp.bfloat16)
    want = []
    for _ in range(3):
        params, opt_state, loss = jstep(params, opt_state, jb)
        want.append(float(loss))

    model = _port_model(jparams).to(torch.bfloat16)
    step = make_train_step(model, make_training_setup(model, learning_rate=LR))
    tb = _tbatch(batch)
    tb["doc_pixels"] = tb["doc_pixels"].to(torch.bfloat16)
    got = [float(step(tb)) for _ in range(3)]
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
    assert got[-1] < got[0] and want[-1] < want[0]


def test_train_step_reduces_loss():
    """The port's counterpart of JAX's test_train_step_reduces_loss: random
    tiny ColPali, batch of 4, 5 steps at 1e-3: finite, falling losses."""
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_

    model = ColPaliModel(TCFG, device="cpu")
    init_random_params_(model, 0)
    opt = make_training_setup(model, learning_rate=LR)
    step = make_train_step(model, opt)
    batch = _tbatch(_batch(2, b=4))
    losses = [float(step(batch)) for _ in range(STEPS)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_remat_step_equals_plain(jparams):
    """``remat=True`` recomputes the forwards in the backward pass: the same
    loss (rel 1e-6, JAX's test) and the same parameters after a step."""
    out = []
    for remat in (False, True):
        model = _port_model(jparams)
        step = make_train_step(model, make_training_setup(model, learning_rate=LR), remat=remat)
        loss = float(step(_tbatch(_batch(3))))
        out.append((loss, {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    for name, p in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], p, rtol=1e-5, atol=1e-6, msg=name)


def test_adamw_state_from_optax_resumes_a_jax_run(jparams):
    """One JAX step, then the params (``params_from_flax``) and the Adam
    state (``adamw_state_from_optax``) carried into the port: its next step
    equals JAX's next step (loss rel 1e-5, parameters as ``_check_params``
    holds them after two steps)."""
    model_j = JColPali(JCFG)
    params, opt_state, optimizer = JT.make_training_setup(model_j, jparams, learning_rate=LR)
    jstep = JT.make_train_step(model_j, optimizer)
    batch = _batch(4)
    params, opt_state, _ = jstep(params, opt_state, _jbatch(batch))
    want_params, _, want_loss = jstep(params, opt_state, _jbatch(batch))

    model = ColPaliModel(TCFG, device="cpu")
    model.load_state_dict(convert.params_from_flax(jax.tree.map(np.asarray, params), TCFG))
    opt = make_training_setup(model, learning_rate=LR)
    state = adamw_state_from_optax(opt_state, model)
    assert set(state) == set(model.parameters())
    assert all(float(s["step"]) == 1.0 for s in state.values())
    adam = opt_state[0]   # optax.adamw: (ScaleByAdamState, ...)
    w = model.embedding_proj_layer.weight
    assert torch.equal(state[w]["exp_avg"],
                       torch.from_numpy(np.array(adam.mu["embedding_proj_layer"]["kernel"]).T))
    assert torch.equal(state[w]["exp_avg_sq"],
                       torch.from_numpy(np.array(adam.nu["embedding_proj_layer"]["kernel"]).T))
    opt.state.update(state)
    loss = float(make_train_step(model, opt)(_tbatch(batch)))
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    _check_params(model, want_params, 2)


def test_adamw_state_from_optax_refuses_a_state_without_adam():
    with pytest.raises(ValueError, match="no Adam state"):
        adamw_state_from_optax((optax.EmptyState(),), ColPaliModel(TCFG, device="cpu"))


def test_training_refuses_a_mesh(jparams, tmp_path):
    """The mesh path that replaced the refusal (DP x TP training): on a
    one-rank (data, model) = (1, 1) gloo mesh, the card's world size,
    ``make_training_setup(mesh=)`` records the mesh and cuts nothing, and
    two steps of ``make_train_step(mesh=)`` equal the mesh-less steps (loss
    and every parameter bit for bit: no collective runs on axes of one
    rank). A mesh the model was not set up on is refused. The multi-rank
    meshes are tests/test_torch_tp_training.py's."""
    import parallel_worker

    batch = _tbatch(_batch(5))
    runs = []
    with parallel_worker.one_rank_mesh(tmp_path, ("data", "model"), (1, 1)) as mesh:
        for on_mesh in (False, True):
            model = _port_model(jparams)
            opt = make_training_setup(model, learning_rate=LR, mesh=mesh if on_mesh else None)
            assert (getattr(model, "mesh", None) is mesh) == on_mesh
            if not on_mesh:
                with pytest.raises(ValueError, match="make_training_setup"):
                    make_train_step(model, opt, mesh=mesh)
            step = make_train_step(model, opt, mesh=mesh if on_mesh else None)
            runs.append(([float(step(batch)) for _ in range(2)],
                         {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert runs[1][0] == runs[0][0]
    for name, p in runs[0][1].items():
        assert torch.equal(runs[1][1][name], p), name


def test_jax_fused_attention_has_no_gradient():
    """F10's pin: ``jax.grad`` through the JAX package's Pallas attention
    (``interpret=True``, as its own tests run it on the CPU) raises
    ``NotImplementedError``: ``pallas_call`` has no reverse mode, and the
    kernel has no ``custom_vjp``. ``layers._fused_attention_enabled`` turns
    it on for S >= 512 on a TPU, so a ColPali train step (S = 1,024 in the
    tower) would reach it there."""
    from multimodal_colpali_tpu.ops.attention import fused_attention

    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 16, 2, 8)), jnp.float32)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda q: fused_attention(q, x, x, None, None, scale=0.3,
                                           interpret=True).sum())(x)


# -- checkpoints --------------------------------------------------------------------

def _trained(seed: int, steps: int = 1):
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_

    model = ColPaliModel(ColPaliModelConfig.tiny(), device="cpu")
    init_random_params_(model, seed)
    opt = make_training_setup(model, learning_rate=LR)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(seed)
    batch = {"query_ids": torch.from_numpy(rng.integers(3, 60, (2, 6))),
             "query_mask": torch.ones(2, 6, dtype=torch.long),
             "doc_ids": torch.full((2, 6), 63), "doc_mask": torch.ones(2, 6, dtype=torch.long),
             "doc_pixels": torch.from_numpy(rng.uniform(-1, 1, (2, 28, 28, 3))).float()}
    batch["doc_ids"][:, 4:] = 5
    for _ in range(steps):
        step(batch)
    return model, opt, step, batch


def _fresh():
    model = ColPaliModel(ColPaliModelConfig.tiny(), device="cpu")
    torch.nn.init.zeros_(model.embed.embed_tokens)
    return model, make_training_setup(model, learning_rate=LR)


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save after step 2, restore into a fresh model and optimizer: the
    state equals, and step 3 from it equals the uninterrupted step 3 bit for
    bit."""
    model, opt, step, batch = _trained(0, steps=2)
    mgr = make_checkpoint_manager(tmp_path / "ckpt")
    save_train_state(mgr, 2, model, opt)
    want_loss = float(step(batch))
    want = {n: p.detach().clone() for n, p in model.named_parameters()}

    model2, opt2 = _fresh()
    assert restore_train_state(mgr, model2, opt2) == 2
    assert float(make_train_step(model2, opt2)(batch)) == want_loss
    for n, p in model2.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    assert all(s["step"].device.type == "cpu" for s in opt2.state.values())


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    model, opt, _, _ = _trained(1)
    mgr = make_checkpoint_manager(tmp_path, max_to_keep=2)
    for s in (1, 5, 3, 9):
        save_train_state(mgr, s, model, opt)
    assert mgr.all_steps() == [5, 9]
    assert mgr.latest_step() == 9
    assert sorted(p.name for p in tmp_path.iterdir()) == ["5", "9"]


def test_checkpoint_restores_an_explicit_step(tmp_path):
    model, opt, step, batch = _trained(2)
    mgr = make_checkpoint_manager(tmp_path)
    save_train_state(mgr, 1, model, opt)
    first = model.embedding_proj_layer.weight.detach().clone()
    step(batch)
    save_train_state(mgr, 2, model, opt)
    model2, opt2 = _fresh()
    assert restore_train_state(mgr, model2, opt2, step=1) == 1
    assert torch.equal(model2.embedding_proj_layer.weight.detach(), first)
    assert restore_train_state(mgr, model2, opt2) == 2
    assert torch.equal(model2.embedding_proj_layer.weight.detach(),
                       model.embedding_proj_layer.weight.detach())
    with pytest.raises(FileNotFoundError, match="step 7"):
        restore_train_state(mgr, model2, opt2, step=7)


def test_checkpoint_restore_without_a_step_raises(tmp_path):
    model, opt = _fresh()
    mgr = make_checkpoint_manager(tmp_path / "empty")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_train_state(mgr, model, opt)


def test_checkpoint_ignores_a_leftover_temporary_directory(tmp_path):
    """A save that died leaves its temporary directory: it is no step, and
    a later save of the same step still lands."""
    model, opt, _, _ = _trained(3)
    mgr = make_checkpoint_manager(tmp_path)
    save_train_state(mgr, 4, model, opt)
    (tmp_path / f".tmp-6-{os.getpid()}").mkdir()
    (tmp_path / f".tmp-6-{os.getpid()}" / "state.pt").write_bytes(b"partial")
    (tmp_path / "8").mkdir()      # a step directory without its file
    assert mgr.all_steps() == [4]
    model2, opt2 = _fresh()
    assert restore_train_state(mgr, model2, opt2) == 4
    save_train_state(mgr, 6, model, opt)
    assert mgr.latest_step() == 6
    assert not (tmp_path / f".tmp-6-{os.getpid()}").exists()


def test_checkpoint_manager_refuses_bad_settings(tmp_path):
    with pytest.raises(ValueError, match="max_to_keep"):
        make_checkpoint_manager(tmp_path, max_to_keep=0)
    model, opt = _fresh()
    with pytest.raises(ValueError, match="step"):
        save_train_state(make_checkpoint_manager(tmp_path), -1, model, opt)

