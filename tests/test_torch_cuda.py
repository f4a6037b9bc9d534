"""The port's kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports torch and the port only (no JAX), so it also runs on a machine
without JAX; there, skip the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from multimodal_colpali_tpu_torch.ops import attention as A
from multimodal_colpali_tpu_torch.ops import maxsim as M
from multimodal_colpali_tpu_torch.ops import preprocess as PP
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,p,nt,dim", [
    (2, 5, 7, 12, 128),     # ragged
    (1, 3, 9, 16, 8),       # B = 1, odd P, narrow
    (3, 50, 5, 70, 72),     # 150 rows: two passes, a query split across them
    (1030, 1, 3, 4, 16),    # more queries than one launch takes
])
def test_maxsim_kernel_matches_plain(gen, dtype, b, nq, p, nt, dim):
    q = _randn(gen, b, nq, dim, dtype=dtype)
    d = _randn(gen, p, nt, dim, dtype=dtype)
    q_lens = torch.randint(1, nq + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    d_lens = torch.randint(1, nt + 1, (p,), generator=gen, device="cuda", dtype=torch.int32)
    d_lens[0] = 0  # an empty page scores -q_len * 1e30
    before = M.maxsim_scores_cuda.launches
    got = M.maxsim_scores(q, d, q_lens, d_lens)
    assert M.maxsim_scores_cuda.launches > before
    want = M.maxsim_scores_reference(q, d, q_lens, d_lens)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[:, 0].double(), -q_lens.double() * 1e30, rtol=1e-6, atol=0)
    _, ki = topk_with_stable_ties(got, min(3, p))
    _, pi = topk_with_stable_ties(want, min(3, p))
    assert torch.equal(ki, pi)


def test_maxsim_casts_query_to_bf16_corpus(gen):
    q = _randn(gen, 2, 4, 32)
    d = _randn(gen, 5, 6, 32, dtype=torch.bfloat16)
    got = M.maxsim_scores_cuda(q, d)
    want = M.maxsim_scores_reference(q.to(torch.bfloat16), d)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_maxsim_rejects_bad_dim(gen):
    with pytest.raises(ValueError):
        M.maxsim_scores(_randn(gen, 1, 2, 12), _randn(gen, 3, 4, 12))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [8, 20, 24, 72, 128])
@pytest.mark.parametrize("masks", ["none", "kv_lens", "kv_valid", "causal", "all"])
def test_attention_kernel_matches_plain(gen, dtype, atol, d, masks):
    b, s, h = 2, 150, 3
    q, k, v = (_randn(gen, b, s, h, d, dtype=dtype) for _ in range(3))
    kw = {}
    if masks in ("kv_lens", "all"):
        kw["kv_lens"] = torch.tensor([s, 37], dtype=torch.int32, device="cuda")
    if masks in ("kv_valid", "all"):
        valid = torch.rand(b, s, generator=gen, device="cuda") > 0.5
        valid[1] = False  # every key masked: uniform weights, as the JAX paths
        kw["kv_valid"] = valid
    if masks in ("causal", "all"):
        kw["causal"] = True
    before = A.fused_attention_cuda.launches
    got = A.fused_attention(q, k, v, scale=d ** -0.5, **kw)
    assert A.fused_attention_cuda.launches == before + 1
    want = A.attention_reference(q, k, v, scale=d ** -0.5, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("b,nq,p,nt,dim", [
    (2, 5, 7, 12, 128),     # ragged
    (1, 3, 9, 16, 8),       # B = 1, odd P, narrow
    (3, 50, 5, 70, 72),     # 150 rows: two passes
    (4, 32, 129, 130, 128),  # odd page count, tokens past one 64-token tile
])
def test_maxsim_int8_kernel_matches_plain(gen, b, nq, p, nt, dim):
    q = _randn(gen, b, nq, dim)
    codes, scales = M.quantize_corpus_int8(_randn(gen, p, nt, dim))
    q_lens = torch.randint(1, nq + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    d_lens = torch.randint(1, nt + 1, (p,), generator=gen, device="cuda", dtype=torch.int32)
    d_lens[0] = 0
    before = M.maxsim_scores_int8_cuda.launches
    got = M.maxsim_scores_int8(q, codes, scales, q_lens, d_lens)
    assert M.maxsim_scores_int8_cuda.launches == before + 1
    want = M.maxsim_scores_int8_reference(q, codes, scales, q_lens, d_lens)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[:, 0].double(), -q_lens.double() * 1e30, rtol=1e-6, atol=0)
    _, ki = topk_with_stable_ties(got, min(3, p))
    _, pi = topk_with_stable_ties(want, min(3, p))
    assert torch.equal(ki, pi)


def test_quantize_on_card_equals_cpu(gen):
    d = _randn(gen, 6, 9, 16, dtype=torch.bfloat16)
    d[1, 2] = 0  # an all-zero token keeps scale 1.0
    codes, scales = M.quantize_corpus_int8(d)
    c_cpu, s_cpu = M.quantize_corpus_int8(d.cpu())
    assert torch.equal(codes.cpu(), c_cpu) and torch.equal(scales.cpu(), s_cpu)
    assert float(scales[1, 2]) == 1.0


def _layer_weights(gen, h, inter, dtype=torch.bfloat16):
    def w(o, i):
        return (torch.randn(o, i, generator=gen, device="cuda") * i ** -0.5).to(dtype)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)

    return dict(ln1_g=vec(h, 1.0), ln1_b=vec(h), wq=w(h, h), bq=vec(h), wk=w(h, h), bk=vec(h),
                wv=w(h, h), bv=vec(h), wo=w(h, h), bo=vec(h), ln2_g=vec(h, 1.0), ln2_b=vec(h),
                w1=w(inter, h), b1=vec(inter), w2=w(h, inter), b2=vec(h))


ATTN_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
MLP_KEYS = ("w1", "b1", "w2", "b2")


def _fused_case(wts, which, heads):
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    if which == "layer":
        return FL.fused_vit_layer_cuda, FL.fused_vit_layer_reference, \
            [wts[k] for k in wts], dict(heads=heads)
    if which == "attn":
        return FL.fused_vit_attention_block_cuda, FL.fused_vit_attention_block_reference, \
            [wts["ln1_g"], wts["ln1_b"]] + [wts[k] for k in ATTN_KEYS], dict(heads=heads)
    return FL.fused_mlp_block_cuda, FL.fused_mlp_block_reference, \
        [wts["ln2_g"], wts["ln2_b"]] + [wts[k] for k in MLP_KEYS], {}


@pytest.mark.parametrize("b,s,h,heads,inter", [
    (2, 256, 256, 4, 512),      # the CPU tests' shape
    (3, 100, 128, 2, 384),      # rows not a multiple of either GEMM's row tile
    (2, 1024, 768, 12, 3072),   # ColSmol's SigLIP layer
])
@pytest.mark.parametrize("which", ["layer", "attn", "mlp"])
@pytest.mark.parametrize("dtype,tol", [
    # tests/test_fused_layer.py's tolerance: bf16 intermediates may round apart
    (torch.bfloat16, 3e-2),
    # a float32 model takes the CUDA-core GEMM and rounds nothing narrower
    (torch.float32, 1e-4),
])
def test_fused_layer_kernels_match_plain(gen, b, s, h, heads, inter, which, dtype, tol):
    kernel, plain, args, kw = _fused_case(_layer_weights(gen, h, inter, dtype), which, heads)
    x = _randn(gen, b, s, h, dtype=dtype)
    before = kernel.launches
    got = kernel(x, *args, **kw)
    assert kernel.launches == before + 1
    want = plain(x, *args, **kw)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("which", ["layer", "attn", "mlp"])
def test_fused_layer_kernels_reject_float16(gen, which):
    kernel, _, args, kw = _fused_case(_layer_weights(gen, 128, 256, torch.float16), which, 2)
    before = kernel.launches
    with pytest.raises(TypeError):
        kernel(_randn(gen, 1, 128, 128, dtype=torch.float16), *args, **kw)
    assert kernel.launches == before


def test_float32_colidefics3_on_card_takes_k5a(gen):
    """A float32 ColIdefics3 whose SigLIP layers ``layer_plan`` admits runs
    them as K5a on the card (the gate asks no dtype) and agrees with the
    same model's unfused float32 forward on the CPU."""
    import copy

    from multimodal_colpali_tpu_torch.models.configs import (
        ColIdefics3ModelConfig, SiglipVisionConfig)
    from multimodal_colpali_tpu_torch.models.idefics3 import ColIdefics3Model
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    base = ColIdefics3ModelConfig.tiny()
    vision = SiglipVisionConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                                num_attention_heads=4, image_size=128, patch_size=8)
    cfg = ColIdefics3ModelConfig(vision=vision, text=base.text, embedding_dim=8,
                                 image_token_id=base.image_token_id, scale_factor=2)
    cpu = ColIdefics3Model(cfg, device="cpu", dtype=torch.float32).eval()
    init_random_params_(cpu, seed=3, family="colidefics3")
    card = copy.deepcopy(cpu).to("cuda")
    n_img = vision.num_patches // cfg.scale_factor ** 2
    ids = torch.tensor([[1, 2] + [cfg.image_token_id] * n_img + [3, 4]] * 2)
    mask = torch.ones_like(ids)
    pix = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(4))
    before = FL.fused_vit_layer_cuda.launches
    with torch.inference_mode():
        got = card(ids.cuda(), mask.cuda(), pix.cuda())
        want = cpu(ids, mask, pix)
    assert FL.fused_vit_layer_cuda.launches == before + vision.num_hidden_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_cuda_tensors_never_take_the_plain_versions(gen, monkeypatch):
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor took a plain version")

    for mod, name in ((M, "maxsim_scores_reference"), (M, "maxsim_scores_int8_reference"),
                      (A, "attention_reference"), (PP, "normalize_images_reference"),
                      (FL, "fused_vit_layer_reference"),
                      (FL, "fused_vit_attention_block_reference"),
                      (FL, "fused_mlp_block_reference")):
        monkeypatch.setattr(mod, name, boom)
    counters = [M.maxsim_scores_cuda, M.maxsim_scores_int8_cuda, A.fused_attention_cuda,
                PP.normalize_images_triton, FL.fused_vit_layer_cuda,
                FL.fused_vit_attention_block_cuda, FL.fused_mlp_block_cuda]
    before = [f.launches for f in counters]
    q, d = _randn(gen, 1, 4, 16), _randn(gen, 3, 5, 16)
    M.maxsim_scores(q, d)
    M.maxsim_scores_int8(q, *M.quantize_corpus_int8(d))
    x4 = _randn(gen, 1, 8, 2, 16)
    A.fused_attention(x4, x4, x4, scale=0.25)
    PP.normalize_images(torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device="cuda"))
    wts = _layer_weights(gen, 128, 256)
    x = _randn(gen, 1, 128, 128, dtype=torch.bfloat16)
    FL.fused_vit_layer(x, *wts.values(), heads=2)
    FL.fused_vit_attention_block(x, wts["ln1_g"], wts["ln1_b"], *(wts[k] for k in ATTN_KEYS),
                                 heads=2)
    FL.fused_mlp_block(x, wts["ln2_g"], wts["ln2_b"], *(wts[k] for k in MLP_KEYS))
    torch.cuda.synchronize()
    assert all(f.launches > n for f, n in zip(counters, before))


@pytest.mark.parametrize("shape", [(2, 28, 28, 3), (3, 448, 448, 3), (1, 5, 7, 3)])
@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3),
                                      ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))])
def test_normalize_kernel_within_one_ulp(gen, shape, mean, std):
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.uint8)
    before = PP.normalize_images_triton.launches
    got = PP.normalize_images(x, mean, std)
    assert PP.normalize_images_triton.launches == before + 1
    want = PP.normalize_images_reference(x, mean, std)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1
