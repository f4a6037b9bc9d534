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
