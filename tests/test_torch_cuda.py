"""The port's kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports torch and the port only (no JAX), so it also runs on a machine
without JAX; there, skip the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
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


# last tiles of 1, 15, 16, 63, 64, 65 tokens and stages that end full or one
# past (bf16 and int8 stages both hold 128 tokens of 128), an empty page, and
# the last page full so that K4's scales end with the tensor
_TC_LENS = [0, 1, 15, 16, 63, 64, 65, 127, 128, 129, 255, 256, 257, 259]


def _tc_case(gen, kind, b, nq, dim, nt=259):
    """Queries, a corpus of ``kind`` ("bf16" pages or "int8" codes and
    scales), ragged q_lens and _TC_LENS page lengths; the kernel call and
    the plain version's."""
    q = _randn(gen, b, nq, dim)
    q_lens = torch.randint(1, nq + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    q_lens[0] = nq
    d_lens = torch.tensor(_TC_LENS, dtype=torch.int32, device="cuda").clamp(max=nt)
    d = _randn(gen, len(_TC_LENS), nt, dim)
    if kind == "bf16":
        qb, db = q.to(torch.bfloat16), d.to(torch.bfloat16)
        return (lambda: M.maxsim_scores_cuda(qb, db, q_lens, d_lens),
                lambda: M.maxsim_scores_reference(qb, db, q_lens, d_lens), q_lens,
                M.maxsim_scores_cuda)
    codes, scales = M.quantize_corpus_int8(d)
    return (lambda: M.maxsim_scores_int8_cuda(q, codes, scales, q_lens, d_lens),
            lambda: M.maxsim_scores_int8_reference(q, codes, scales, q_lens, d_lens), q_lens,
            M.maxsim_scores_int8_cuda)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("b,nq,dim", [
    (4, 32, 128),    # phase 2's rows
    (1, 32, 128),    # the store's one query: one row group, 8 warps on its tokens
    (9, 32, 128),    # 288 rows: two launches
    (2, 300, 128),   # NQ > R: a query alone, its block walks two passes
    (3, 20, 16),     # narrow, rows not on m16 tiles
    (2, 7, 48),      # an odd number of 16-byte groups a token
    (5, 13, 80),
])
def test_maxsim_tensor_core_path_matches_plain(gen, kind, b, nq, dim):
    call, plain, q_lens, fn = _tc_case(gen, kind, b, nq, dim)
    before, tc = fn.launches, fn.tensor_core_launches
    got = call()
    n = len(M.launch_plan(b, nq))
    assert fn.launches == before + n and fn.tensor_core_launches == tc + n
    want = plain()
    assert torch.isfinite(got).all()
    rtol, atol = (1e-4, 1e-3) if kind == "bf16" else (1e-4, 1e-4)
    torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=rtol, atol=atol)
    # an empty page: q_len row maxima of -1e30 summed in row order in float32
    # (300 of them are off -q_len * 1e30 by ~3e-6 of it)
    assert got[:, 0].tolist() == [_row_order_sum(-1e30, n) for n in q_lens.tolist()]


def _row_order_sum(x: float, n: int) -> float:
    s, v = np.float32(0), np.float32(x)
    for _ in range(n):
        s = np.float32(s + v)
    return float(s)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_maxsim_tensor_core_path_bit_invariances(gen, kind):
    """A repeated call, a page alone and a query alone (launches of other
    rows than the batch's) all give the same bits."""
    b, nq, dim, nt = 20, 32, 128, 259
    q = _randn(gen, b, nq, dim)
    d = _randn(gen, len(_TC_LENS), nt, dim)
    q_lens = torch.randint(1, nq + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    d_lens = torch.tensor(_TC_LENS, dtype=torch.int32, device="cuda")
    if kind == "bf16":
        q, d = q.to(torch.bfloat16), d.to(torch.bfloat16)
        call = lambda qq, ql, p0, p1: M.maxsim_scores_cuda(  # noqa: E731
            qq, d[p0:p1], ql, d_lens[p0:p1])
    else:
        codes, scales = M.quantize_corpus_int8(d)
        call = lambda qq, ql, p0, p1: M.maxsim_scores_int8_cuda(  # noqa: E731
            qq, codes[p0:p1], scales[p0:p1], ql, d_lens[p0:p1])
    p = len(_TC_LENS)
    full = call(q, q_lens, 0, p)                      # 640 rows: three launches
    assert torch.equal(call(q, q_lens, 0, p), full)
    assert torch.equal(call(q, q_lens, 3, p), full[:, 3:])     # an odd page count, offset
    assert torch.equal(call(q, q_lens, 5, 6), full[:, 5:6])    # one page alone
    ones = torch.cat([call(q[i: i + 1], q_lens[i: i + 1], 0, p) for i in range(b)])
    assert torch.equal(ones, full)


@pytest.mark.parametrize("dtype,dim,kind", [
    (torch.float32, 128, "maxsim"), (torch.bfloat16, 72, "maxsim"),
    (torch.float32, 72, "int8"), (torch.float32, 128, "int8")])
def test_maxsim_path_by_dtype_and_dim(gen, dtype, dim, kind):
    """float32 pages and DIMs off 16 take the CUDA-core kernel; int8 codes
    of DIM % 16 == 0 the tensor-core one."""
    q, d = _randn(gen, 2, 5, dim, dtype=dtype), _randn(gen, 3, 9, dim, dtype=dtype)
    fn = M.maxsim_scores_cuda if kind == "maxsim" else M.maxsim_scores_int8_cuda
    tc, cc = fn.tensor_core_launches, fn.cuda_core_launches
    if kind == "maxsim":
        got, want = fn(q, d), M.maxsim_scores_reference(q, d)
    else:
        codes, scales = M.quantize_corpus_int8(d)
        got = fn(q.float(), codes, scales)
        want = M.maxsim_scores_int8_reference(q.float(), codes, scales)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    on_tc = M.tensor_core_path(torch.int8 if kind == "int8" else dtype, dim)
    assert (fn.tensor_core_launches - tc, fn.cuda_core_launches - cc) == (
        (1, 0) if on_tc else (0, 1))
    assert on_tc == (kind == "int8" and dim == 128)


def test_maxsim_two_streams_share_nothing(gen):
    """K1 and K4 in flight together on two streams, one of them a CUDA graph
    replay, each give the bits of a lone call."""
    call1, _, _, _ = _tc_case(gen, "bf16", 4, 32, 128)
    call2, _, _, _ = _tc_case(gen, "int8", 9, 32, 128)
    want1, want2 = call1(), call2()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    s1.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        with torch.cuda.graph(graph, stream=s1):
            got1 = call1()
    torch.cuda.synchronize()
    s2.wait_stream(torch.cuda.current_stream())
    outs1, outs2 = [], []
    for _ in range(20):
        with torch.cuda.stream(s1):
            graph.replay()
            outs1.append(got1.clone())
        with torch.cuda.stream(s2):
            outs2.append(call2())
    torch.cuda.synchronize()
    assert all(torch.equal(o, want1) for o in outs1)
    assert all(torch.equal(o, want2) for o in outs2)


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
    fn = A.fused_attention_cuda
    before = (fn.launches, fn.tensor_core_launches, fn.tf32_launches, fn.cuda_core_launches)
    got = A.fused_attention(q, k, v, scale=d ** -0.5, **kw)
    # float32 takes the 3xTF32 tensor-core path at every D; bf16 with D % 8 == 0
    # the bf16 tensor cores, bf16 at D = 20 the CUDA cores
    tf32 = dtype == torch.float32
    tensor_core = dtype == torch.bfloat16 and d % 8 == 0
    assert (fn.launches, fn.tensor_core_launches, fn.tf32_launches, fn.cuda_core_launches) == (
        before[0] + 1, before[1] + tensor_core, before[2] + tf32,
        before[3] + (not tf32 and not tensor_core))
    want = A.attention_reference(q, k, v, scale=d ** -0.5, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def _attention_masks(gen, b, s, masks):
    kw = {}
    if masks in ("kv_lens", "all"):
        kw["kv_lens"] = torch.tensor([s, s // 3 + 1][:b], dtype=torch.int32, device="cuda")
    if masks in ("kv_valid", "all"):
        valid = torch.rand(b, s, generator=gen, device="cuda") > 0.5
        valid[-1] = False  # every key of the last batch row masked: uniform weights
        kw["kv_valid"] = valid
    if masks in ("causal", "all"):
        kw["causal"] = True
    return kw


@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("s", [40, 577, 1024, 1031])
@pytest.mark.parametrize("masks", ["none", "kv_lens", "kv_valid", "causal", "all"])
def test_attention_tensor_core_path_matches_plain(gen, d, s, masks):
    """K2's tensor-core path (bf16, D % 8 == 0) against the plain version at
    atol 2e-2: SigLIP-768's D = 64, So400m's 72, 128; ragged key tiles (S =
    40, 577, 1031) and 64- and 128-row query blocks; each mask and all three."""
    b, h = 2, 2
    q, k, v = (_randn(gen, b, s, h, d, dtype=torch.bfloat16) for _ in range(3))
    kw = _attention_masks(gen, b, s, masks)
    before = (A.fused_attention_cuda.tensor_core_launches,
              A.fused_attention_cuda.cuda_core_launches)
    got = A.fused_attention_cuda(q, k, v, scale=d ** -0.5, **kw)
    assert A.fused_attention_cuda.tensor_core_launches == before[0] + 1
    assert A.fused_attention_cuda.cuda_core_launches == before[1]
    want = A.attention_reference(q, k, v, scale=d ** -0.5, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("s", [40, 1031])
def test_attention_tensor_core_path_fully_masked_row_is_uniform(gen, s):
    """A batch row whose keys are all masked averages V over all S keys, as
    the finite -1e30 fill does in the JAX paths; keys past S weigh nothing."""
    b, h, d = 2, 3, 72
    q, k, v = (_randn(gen, b, s, h, d, dtype=torch.bfloat16) for _ in range(3))
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    valid[1] = False
    got = A.fused_attention_cuda(q, k, v, kv_valid=valid, scale=d ** -0.5)
    mean = v[1].float().mean(dim=0, keepdim=True).expand(s, h, d)
    torch.testing.assert_close(got[1].float(), mean, rtol=0, atol=2e-2)
    lens = torch.tensor([s, 0], dtype=torch.int32, device="cuda")
    got = A.fused_attention_cuda(q, k, v, kv_lens=lens, causal=True, scale=d ** -0.5)
    torch.testing.assert_close(got[1].float(), mean, rtol=0, atol=2e-2)


def test_attention_tensor_core_path_takes_unaligned_views(gen):
    b, s, h, d = 1, 130, 2, 72
    qkv = [_randn(gen, b, s, h, d, dtype=torch.bfloat16) for _ in range(3)]
    off = []
    for x in qkv:
        y = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16
        off.append(y)
    before = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(*off, scale=0.1)
    assert A.fused_attention_cuda.tensor_core_launches == before + 1
    assert torch.equal(got, A.fused_attention_cuda(*qkv, scale=0.1))


def _tf32_forward_check(gen, b, s, h, d, masks):
    """K2's float32 forward (3xTF32) against the plain version at atol 1e-4,
    its path counter, and a repeat bit-identical."""
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    kw = _attention_masks(gen, b, s, masks)
    if "kv_lens" in kw:  # one length a batch row, the last one short
        kw["kv_lens"] = torch.tensor([s] * (b - 1) + [s // 3 + 1], dtype=torch.int32,
                                     device="cuda")
    fn = A.fused_attention_cuda
    before = (fn.tf32_launches, fn.tensor_core_launches, fn.cuda_core_launches)
    got = fn(q, k, v, scale=d ** -0.5, **kw)
    assert (fn.tf32_launches, fn.tensor_core_launches, fn.cuda_core_launches) == (
        before[0] + 1, before[1], before[2])
    want = A.attention_reference(q, k, v, scale=d ** -0.5, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(fn(q, k, v, scale=d ** -0.5, **kw), got)
    if "kv_valid" in kw:  # the last batch row sees no key: the mean of V
        torch.testing.assert_close(got[-1], v[-1].mean(dim=0, keepdim=True).expand(s, h, d),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [6, 72, 128])
@pytest.mark.parametrize("s", [40, 577, 1031])
@pytest.mark.parametrize("masks", ["none", "kv_lens", "kv_valid", "causal", "all"])
def test_attention_tf32_path_matches_plain(gen, d, s, masks):
    """K2's float32 path on the tensor cores in 3xTF32: ragged key tiles (S =
    40, 577, 1031), D = 6 (4-byte copies), So400m's 72, 128 (32-key tiles),
    each mask and all three."""
    _tf32_forward_check(gen, 2, s, 2, d, masks)


@pytest.mark.parametrize("masks", ["none", "kv_lens", "kv_valid", "causal", "all"])
def test_attention_tf32_path_at_the_training_shape(gen, masks):
    """The training path's ``[3, 1024, 16, 72]`` float32 forward (ColPali's
    So400m over 3 pages) on the 3xTF32 path, each mask."""
    _tf32_forward_check(gen, 3, 1024, 16, 72, masks)


def test_attention_tf32_paths_take_unaligned_views(gen):
    """float32 views 4 bytes off a 16-byte boundary take 4-byte copies
    inside the same kernels, forward and backward: the same bits."""
    b, s, h, d = 1, 130, 2, 72
    xs = [_randn(gen, b, s, h, d) for _ in range(4)]
    off = []
    for x in xs:
        y = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16
        off.append(y)
    before = A.fused_attention_cuda.tf32_launches
    got = A.fused_attention_cuda(*off[:3], scale=0.1)
    assert A.fused_attention_cuda.tf32_launches == before + 1
    assert torch.equal(got, A.fused_attention_cuda(*xs[:3], scale=0.1))
    grads = A.fused_attention_backward_cuda(*off[:3], got, off[3], scale=0.1)
    want = A.fused_attention_backward_cuda(*xs[:3], got, xs[3], scale=0.1)
    assert all(torch.equal(a, w) for a, w in zip(grads, want))


def test_siglip_attention_on_card_takes_the_tensor_core_path(gen):
    """ColPali's So400m attention (``layers.attention``, D = 72) and ColSmol's
    fused SigLIP layer (K5a, D = 64) reach K2's tensor-core path in bf16."""
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    q, k, v = (_randn(gen, 2, 256, 16, 72, dtype=torch.bfloat16) for _ in range(3))
    before = A.fused_attention_cuda.tensor_core_launches
    got = L.attention(q, k, v, None, 72 ** -0.5)
    assert A.fused_attention_cuda.tensor_core_launches == before + 1
    want = A.attention_reference(q, k, v, scale=72 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    wts = _layer_weights(gen, 768, 3072)
    x = _randn(gen, 1, 256, 768, dtype=torch.bfloat16)
    before = A.fused_attention_cuda.tensor_core_launches
    FL.fused_vit_layer_cuda(x, *wts.values(), heads=12)
    assert A.fused_attention_cuda.tensor_core_launches == before + 1


def test_attention_at_the_gemma3_tower_shape(gen):
    """K2 at Gemma-3's SigLIP-So400m at 896 px, 4,096 patches ``[2, 4096, 16,
    72]`` bf16: its tensor-core path against the plain version (one image at
    a time: its float32 scores are 1 GiB an image), a repeat bit-identical.
    The outputs average 4,096 values (std about sqrt(e / 4096) = 0.026), so
    the limit is 5e-3, under the max|err| of about 0.017 that dropping one
    64-key block gives."""
    q, k, v = (_randn(gen, 2, 4096, 16, 72, dtype=torch.bfloat16) for _ in range(3))
    before = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(q, k, v, scale=72 ** -0.5)
    assert A.fused_attention_cuda.tensor_core_launches == before + 1
    for i in range(2):
        want = A.attention_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1], scale=72 ** -0.5)
        torch.testing.assert_close(got[i:i + 1].float(), want.float(), rtol=0, atol=5e-3)
    assert torch.equal(A.fused_attention_cuda(q, k, v, scale=72 ** -0.5), got)


def test_gemma3_tower_runs_27_tensor_core_launches_a_forward(gen):
    """Gemma-3's So400m tower at 896 px (random weights, bf16) takes K2's
    tensor-core path in each of its 27 layers, one launch a layer for a
    batch of images, and no fused layer (``layer_plan`` leaves So400m
    unfused); its patches are finite."""
    from multimodal_colpali_tpu_torch.models.configs import Gemma3MMConfig
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_
    from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    cfg = Gemma3MMConfig.gemma3_27b().vision
    tower = SiglipVisionTower(cfg, device="cuda", dtype=torch.bfloat16).eval()
    init_random_params_(tower, 0, family="siglip")
    pix = _randn(gen, 2, 896, 896, 3, dtype=torch.bfloat16)
    before = (A.fused_attention_cuda.tensor_core_launches, A.fused_attention_cuda.launches,
              FL.fused_vit_layer_cuda.launches)
    with torch.inference_mode():
        out = tower(pix)
    assert out.shape == (2, 4096, 1152) and bool(torch.isfinite(out).all())
    assert A.fused_attention_cuda.tensor_core_launches == before[0] + 27
    assert A.fused_attention_cuda.launches == before[1] + 27
    assert FL.fused_vit_layer_cuda.launches == before[2]


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


# -- the K5 GEMM alone, against gemm_reference ---------------------------------------------

def _gemm_case(gen, m, k, nseg, segs, ln, epilogue):
    """Seeded random bf16 operands of one GEMM: a [m, k], `segs` weights
    [nseg, k] with float32 biases, LN parameters and the residual where asked."""
    a = _randn(gen, m, k, dtype=torch.bfloat16)
    ws = [(_randn(gen, nseg, k) * k ** -0.5).to(torch.bfloat16) for _ in range(segs)]
    bs = [0.1 * _randn(gen, nseg) for _ in range(segs)]
    kw = {}
    if ln:
        kw.update(ln=(1.0 + 0.1 * _randn(gen, k), 0.1 * _randn(gen, k)), eps=1e-6)
    if epilogue == "residual":
        kw.update(resid=_randn(gen, m, nseg, dtype=torch.bfloat16))
    return a, ws, bs, kw


def _epilogue_step(product, epilogue):
    """One bf16 step of ``product`` (the spacing of bf16 values at its
    magnitude) passed through the epilogue: times 1 for the residual, times
    gelu_tanh's slope at that element for gelu."""
    p = product.float()
    step = torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8) * (p != 0)
    if epilogue == "residual":
        return step
    beta, kappa = 0.7978845608028654, 0.044715
    t = torch.tanh(beta * (p + kappa * p ** 3))
    slope = 0.5 * (1 + t) + 0.5 * p * (1 - t * t) * beta * (1 + 3 * kappa * p * p)
    return step * slope.abs()


def _assert_gemm_close(got, want, product=None, epilogue="bias"):
    """Per element within 2^-7·|want| + 2e-3: one bf16 rounding of the
    output, and the sums' order. Gelu and the residual act on the product
    already rounded to bf16 (``product``, the plain version's, held to that
    bound apart): a last-bit disagreement there passes through them, so
    their outputs also get one bf16 step of the product through the
    epilogue (:func:`_epilogue_step`)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    lim = 2.0 ** -7 * want.float().abs() + 2e-3
    if product is not None:
        lim = lim + _epilogue_step(product, epilogue)
    assert bool((err <= lim).all()), f"max excess {float((err - lim).max())}"


def _kernel_ln_input(a, kw):
    """The GEMM's A as the kernel sees it, and the arguments that go with it.
    With a LayerNorm, the kernel on an identity weight gives its normalized
    bf16 A exactly (each product has one nonzero term); that A is held to
    within one bf16 step of F.layer_norm's (two float32 LayerNorms round a
    few elements to neighbouring bf16 values), and the product is then held
    on it, so each rounding point has its own bound."""
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    if "ln" not in kw:
        return a, kw
    k = a.shape[1]
    eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
    xn = FL.fused_gemm_cuda(a, [eye], [torch.zeros(k, device="cuda")], "bias", ln=kw["ln"],
                            eps=kw["eps"])[0]
    ref = FL._layernorm(a, *kw["ln"], kw["eps"]).float()
    assert bool(((xn.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all())
    return xn, {key: v for key, v in kw.items() if key not in ("ln", "eps")}


def _gemm_counts():
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    g = FL.fused_gemm_cuda
    return dict(launches=g.launches, wgmma=g.wgmma_launches, cuda_core=g.cuda_core_launches,
                ln_stats=FL.ln_stats_cuda.launches,
                **{r: getattr(g, f"{r}_launches") for r in FL.GEMM_ROLES})


@pytest.mark.parametrize("m,k,nseg,segs,ln,epilogue", [
    (1, 128, 128, 1, True, "bias"),          # one row
    (100, 768, 768, 3, True, "bias"),        # QKV, rows short of a tile
    (300, 128, 128, 3, True, "gelu"),        # ragged rows, Nseg 128
    (300, 768, 768, 1, False, "residual"),   # out_proj
    (100, 3072, 768, 1, False, "residual"),  # fc2
    (300, 768, 3072, 1, True, "gelu"),       # fc1
    (1, 768, 3072, 1, False, "gelu"),
    (100, 128, 768, 2, False, "bias"),
    (130, 136, 72, 3, True, "bias"),         # K and Nseg short of a stage and a tile
    (300, 136, 72, 1, False, "residual"),
    (16384, 768, 768, 3, True, "bias"),      # ColSmol's batch of 16
    (16384, 768, 3072, 1, True, "gelu"),
    (16384, 3072, 768, 1, False, "residual"),
])
def test_fused_gemm_matches_reference(gen, m, k, nseg, segs, ln, epilogue):
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    a, ws, bs, kw = _gemm_case(gen, m, k, nseg, segs, ln, epilogue)
    before = _gemm_counts()
    got = FL.fused_gemm_cuda(a, ws, bs, epilogue, **kw)
    after = _gemm_counts()
    assert (after["launches"], after["wgmma"], after["cuda_core"], after["ln_stats"]) == (
        before["launches"] + 1, before["wgmma"] + 1, before["cuda_core"], before["ln_stats"] + ln)
    a_ref, kw_ref = _kernel_ln_input(a, kw)
    product = None
    if epilogue != "bias":
        bare = {k: v for k, v in kw.items() if k != "resid"}
        product = FL.gemm_reference(a_ref, ws, bs, "bias")
        _assert_gemm_close(FL.fused_gemm_cuda(a, ws, bs, "bias", **bare), product)
    _assert_gemm_close(got, FL.gemm_reference(a_ref, ws, bs, epilogue, **kw_ref), product,
                       epilogue)
    assert torch.equal(got, FL.fused_gemm_cuda(a, ws, bs, epilogue, **kw))  # a repeat


def _grid_case(gen, m, k, nseg, segs, ln, epilogue):
    """Small integers at power-of-two scales: every float32 sum is exact in
    any order, and each LayerNorm row is mean ± c with c a power of two (its
    rstd 1/c exactly, eps 0), so the normalized row is sign · g + b exactly,
    returned as the last item (None without a LayerNorm). F.layer_norm's own
    rounding can leave ~1e-8 where that is 0, so the plain version is taken
    on the exact normalized rows."""
    def grid(*shape, lo=-4, hi=5, scale=1.0):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda").float() * scale

    kw, xn = {}, None
    if ln:
        sign = torch.ones(m, k, device="cuda")
        sign[:, 1::2] = -1.0
        sign = sign[:, torch.randperm(k, generator=gen, device="cuda")]
        c = 2.0 ** torch.randint(-2, 3, (m, 1), generator=gen, device="cuda").float()
        a = grid(m, 1, scale=0.5) + c * sign
        kw.update(ln=(grid(k, lo=1, hi=4, scale=0.5), grid(k, scale=0.25)), eps=0.0)
        xn = (sign * kw["ln"][0] + kw["ln"][1]).to(torch.bfloat16)
    else:
        a = grid(m, k, scale=0.25)
    ws = [grid(nseg, k, scale=0.125).to(torch.bfloat16) for _ in range(segs)]
    bs = [grid(nseg, scale=0.0625) for _ in range(segs)]
    if epilogue == "residual":
        kw["resid"] = grid(m, nseg, scale=0.5).to(torch.bfloat16)
    return a.to(torch.bfloat16), ws, bs, kw, xn


# gemm_plan on 132 SMs: 128-wide tiles at M 300 (one a block) and for one
# segment at M 8,192; 256-wide for three at M 8,192 and at M 16,384, where
# each persistent block walks 3 to 9 tiles and its ring wraps many times
@pytest.mark.parametrize("m", [300, 8192, 16384])
@pytest.mark.parametrize("ln,epilogue", [(True, "bias"), (True, "gelu"), (False, "bias"),
                                         (False, "gelu"), (False, "residual")])
def test_fused_gemm_exact_on_grid_inputs(gen, m, ln, epilogue):
    """Bit for bit at both tile widths, one tile a block or many."""
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    k, nseg = 768, 384 if m == 300 else 768
    segs = 1 if epilogue == "residual" else 3
    a, ws, bs, kw, xn = _grid_case(gen, m, k, nseg, segs, ln, epilogue)
    got = FL.fused_gemm_cuda(a, ws, bs, epilogue, **kw)
    if ln:
        stats = FL.ln_stats_cuda(a, 0.0)
        assert torch.equal(stats, FL.ln_stats_reference(a, 0.0))
        eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
        assert torch.equal(FL.fused_gemm_cuda(a, [eye], [torch.zeros(k, device="cuda")], "bias",
                                              **kw)[0], xn)
        a, kw = xn, {key: v for key, v in kw.items() if key not in ("ln", "eps")}
    assert torch.equal(got, FL.gemm_reference(a, ws, bs, epilogue, **kw))


@pytest.mark.parametrize("m,k", [(1, 128), (300, 768), (16384, 768), (100, 3072), (7, 136)])
def test_ln_stats_kernel_matches_plain(gen, m, k):
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    a = (_randn(gen, m, k) * 3.0 + 0.5).to(torch.bfloat16)
    before = FL.ln_stats_cuda.launches
    got = FL.ln_stats_cuda(a, 1e-6)
    assert FL.ln_stats_cuda.launches == before + 1
    torch.testing.assert_close(got, FL.ln_stats_reference(a, 1e-6), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, FL.ln_stats_cuda(a, 1e-6))


@pytest.mark.parametrize("ln,epilogue", [(True, "bias"), (False, "residual")])
def test_fused_gemm_views_at_a_16_byte_offset(gen, ln, epilogue):
    """Operands that start 16 bytes into their storage give the same bits as
    fresh ones."""
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    m, k, nseg = 200, 256, 128
    segs = 1 if epilogue == "residual" else 3
    a, ws, bs, kw = _gemm_case(gen, m, k, nseg, segs, ln, epilogue)

    def shifted(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")
        view = buf[8:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 0 and view.data_ptr() != buf.data_ptr()
        return view

    want = FL.fused_gemm_cuda(a, ws, bs, epilogue, **kw)
    kw2 = dict(kw)
    if "resid" in kw2:
        kw2["resid"] = shifted(kw2["resid"])
    got = FL.fused_gemm_cuda(shifted(a), [shifted(w) for w in ws], bs, epilogue, **kw2)
    assert torch.equal(got, want)


def test_fused_gemm_paths_by_dtype(gen):
    """bf16 takes gemm_wgmma (after one statistics launch for a LayerNorm),
    float32 the CUDA-core kernel; a layer's four bf16 GEMMs each count once
    under their role, with two statistics launches and no CUDA-core launch."""
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    a, ws, bs, kw = _gemm_case(gen, 64, 128, 128, 1, True, "gelu")
    before = _gemm_counts()
    got = FL.fused_gemm_cuda(a.float(), [w.float() for w in ws], bs, "gelu", **kw)
    after = _gemm_counts()
    assert (after["cuda_core"], after["wgmma"], after["ln_stats"]) == (
        before["cuda_core"] + 1, before["wgmma"], before["ln_stats"])
    torch.testing.assert_close(got, FL.gemm_reference(a.float(), [w.float() for w in ws], bs,
                                                      "gelu", **kw), rtol=1e-4, atol=1e-4)
    wts = _layer_weights(gen, 256, 512)
    x = _randn(gen, 2, 128, 256, dtype=torch.bfloat16)
    before = _gemm_counts()
    FL.fused_vit_layer_cuda(x, *wts.values(), heads=4)
    after = _gemm_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        launches=4, wgmma=4, cuda_core=0, ln_stats=2, qkv=1, out_proj=1, fc1=1, fc2=1)


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
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor took a plain version")

    for mod, name in ((M, "maxsim_scores_reference"), (M, "maxsim_scores_int8_reference"),
                      (A, "attention_reference"), (PP, "normalize_images_reference"),
                      (FL, "fused_vit_layer_reference"),
                      (FL, "fused_vit_attention_block_reference"),
                      (FL, "fused_mlp_block_reference"), (WA, "window_attention_reference"),
                      (I4, "int4_matmul_reference")):
        monkeypatch.setattr(mod, name, boom)
    counters = [M.maxsim_scores_cuda, M.maxsim_scores_int8_cuda, A.fused_attention_cuda,
                PP.normalize_images_cuda, FL.fused_vit_layer_cuda,
                FL.fused_vit_attention_block_cuda, FL.fused_mlp_block_cuda,
                WA.window_attention_cuda, I4.int4_matmul_kn_cuda]
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
    w3 = _randn(gen, 4, 144, 32, dtype=torch.bfloat16)
    WA.window_attention(w3, w3, w3, scale=0.2)
    I4.int4_matmul_kn(_randn(gen, 2, 64, dtype=torch.bfloat16),
                      torch.zeros(32, 16, dtype=torch.uint8, device="cuda"),
                      torch.ones(1, 16, device="cuda"))
    torch.cuda.synchronize()
    assert all(f.launches > n for f, n in zip(counters, before))


@pytest.mark.parametrize("shape", [(2, 28, 28, 3), (3, 448, 448, 3), (1, 5, 7, 3)])
@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3),
                                      ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))])
def test_normalize_kernel_within_one_ulp(gen, shape, mean, std):
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.uint8)
    before = PP.normalize_images_cuda.launches
    got = PP.normalize_images(x, mean, std)
    assert PP.normalize_images_cuda.launches == before + 1
    want = PP.normalize_images_reference(x, mean, std)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1


def _ulps(a, b):
    return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())


@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3),
                                      ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))])
def test_normalize_kernel_exhaustive_table(gen, mean, std):
    """All 256 byte values in each of the 3 channel positions, within one
    bf16 ulp of the plain version; a repeated call bit-identical."""
    x = torch.arange(256, device="cuda", dtype=torch.uint8)[None, :, None, None].expand(
        1, 256, 1, 3).contiguous()
    got = PP.normalize_images_cuda(x, mean, std)
    assert _ulps(got, PP.normalize_images_reference(x, mean, std)) <= 1
    assert torch.equal(PP.normalize_images_cuda(x, mean, std).view(torch.int16),
                       got.view(torch.int16))


@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (1, 1, 5, 3), (2, 3, 1, 3), (1, 1, 1, 3),
                                   (0, 4, 4, 3)], ids=["n105", "n15", "n18", "n3", "n0"])
def test_normalize_kernel_ragged_tails(gen, shape):
    """n % 48 != 0 (105), n < 48 (15, 18, 3) and n = 0 (no launch)."""
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.uint8)
    before = PP.normalize_images_cuda.launches
    got = PP.normalize_images(x, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    assert PP.normalize_images_cuda.launches == before + (x.numel() > 0)
    assert got.shape == shape and got.dtype == torch.bfloat16
    if x.numel():
        want = PP.normalize_images_reference(x, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
        assert _ulps(got, want) <= 1


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_normalize_kernel_misaligned_view_is_bit_identical(gen, offset):
    """A view whose first pixel is not 16-byte aligned goes element by
    element and gives the aligned call's bits."""
    shape = (2, 28, 20, 3)
    n = int(np.prod(shape))
    flat = torch.randint(0, 256, (n + offset,), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    x = flat[offset:].view(shape)
    assert x.data_ptr() % 16 != 0
    got = PP.normalize_images_cuda(x)
    want = PP.normalize_images_cuda(x.clone())
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert _ulps(got, PP.normalize_images_reference(x)) <= 1


# -- K7a / K7b: paged decode attention ------------------------------------------

def _paged_case(gen, b, hq, hkv, d, page, nb, dtype, lens=None):
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    p_phys = b * nb + 1
    q = _randn(gen, b, hq, d, dtype=dtype)
    k = _randn(gen, p_phys, page, hkv, d, dtype=dtype)
    v = _randn(gen, p_phys, page, hkv, d, dtype=dtype)
    bt = torch.randperm(p_phys, generator=gen, device="cuda")[: b * nb].reshape(b, nb)
    if lens is None:
        lens = torch.randint(1, nb * page + 1, (b,), generator=gen, device="cuda")
        lens[0] = 0                      # an inactive slot: the uniform mean
        lens[-1] = nb * page             # a full one
    else:
        lens = torch.tensor(lens, device="cuda")
    return PA, q, k, v, bt.to(torch.int32), lens.to(torch.int32)


def _path_counts(fn):
    return fn.tensor_core_launches, fn.cuda_core_launches


# Tensor-core shapes: group 1, 2, 4, 8 and 16 with D 64, 128 and 256, pages of
# 8 and 16, each with an inactive slot, a slot of 5 tokens (shorter than 16 x
# splits, so most of its splits hold no token) and a full one; then the paged
# batcher's decode step at gemma-3-27b's heads (4 slots, NB 128).
_TC_SHAPES = [
    (3, 4, 4, 64, 16, 6, [0, 5, 96]),
    (3, 8, 4, 128, 8, 12, [0, 5, 96]),
    (3, 16, 4, 256, 16, 5, [0, 5, 80]),
    (3, 8, 1, 128, 8, 20, [0, 5, 160]),
    (3, 32, 2, 64, 16, 9, [0, 5, 144]),
    (3, 16, 1, 256, 8, 10, [0, 5, 80]),
    (3, 32, 2, 128, 16, 40, [0, 5, 640]),
    (4, 32, 16, 128, 16, 128, [309, 709, 1109, 1509]),
]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,d,page,nb,lens", [
    (3, 8, 2, 64, 16, 4, None),      # GQA 4
    (2, 2, 1, 8, 8, 3, None),        # the tiny test models
    (4, 8, 8, 128, 8, 5, None),      # MHA
    (2, 32, 16, 128, 16, 9, None),   # gemma-3-27b's heads
    (2, 8, 1, 256, 16, 3, None),     # Gemma-1 2B: MQA, head_dim 256
    (2, 3, 1, 20, 5, 3, None),       # D not a multiple of the 16-byte load
    (3, 8, 2, 64, 16, 40, None),     # 640 tokens: three blocks per slot and kv head
    (4, 32, 16, 128, 16, 70, None),  # gemma-3-27b at 1,120 tokens: five blocks
    (2, 4, 1, 256, 8, 70, None),     # head_dim 256 split five ways
    *_TC_SHAPES])
@pytest.mark.parametrize("window", [0, 7, 33, 300, 1024])
def test_paged_attention_kernel_matches_plain(gen, dtype, atol, b, hq, hkv, d, page, nb, lens,
                                              window):
    """K7a against its plain version; bf16 with D % 16 == 0 and group <= 16
    takes the tensor-core path, float32 and D = 20 the CUDA-core path."""
    PA, q, k, v, bt, lens = _paged_case(gen, b, hq, hkv, d, page, nb, dtype, lens)
    fn = PA.paged_attention_cuda
    tensor_core = dtype == torch.bfloat16 and d % 16 == 0 and hq // hkv <= 16
    assert PA.tensor_core_path(dtype, dtype, d, hq // hkv) == tensor_core
    before, paths = fn.launches, _path_counts(fn)
    got = PA.paged_attention(q, k, v, bt, lens, scale=d ** -0.5, window=window)
    assert fn.launches == before + 1
    assert _path_counts(fn) == (paths[0] + tensor_core, paths[1] + (not tensor_core))
    want = PA.paged_attention_reference(q, k, v, bt, lens, scale=d ** -0.5, window=window)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("qdtype,atol", [(torch.float32, 1e-3), (torch.bfloat16, 0.035)])
@pytest.mark.parametrize("b,hq,hkv,d,page,nb,lens", [
    (3, 8, 2, 64, 8, 4, None), (2, 32, 16, 128, 16, 9, None), (2, 2, 1, 8, 8, 3, None),
    (2, 3, 1, 20, 5, 3, None), (3, 32, 16, 128, 16, 70, None), (2, 3, 1, 20, 5, 60, None),
    *_TC_SHAPES])
@pytest.mark.parametrize("window", [0, 6, 300, 1024])
def test_paged_attention_int8_kernel_matches_plain(gen, qdtype, atol, b, hq, hkv, d, page, nb,
                                                   lens, window):
    """K7b against the dequantize-first plain version: with float32 q only the
    order of the scale products differs (1e-3); with bf16 q the plain version
    also rounds the dequantized rows, so tests/test_paged.py's 0.035. bf16 q
    with D % 16 == 0 and group <= 16 takes the tensor-core path."""
    PA, q, k, v, bt, lens = _paged_case(gen, b, hq, hkv, d, page, nb, torch.float32, lens)
    kc, ks = PA.quantize_kv_rows(k)
    vc, vs = PA.quantize_kv_rows(v)
    q = q.to(qdtype)
    fn = PA.paged_attention_int8_cuda
    tensor_core = qdtype == torch.bfloat16 and d % 16 == 0 and hq // hkv <= 16
    before, paths = fn.launches, _path_counts(fn)
    got = PA.paged_attention_int8(q, kc, ks, vc, vs, bt, lens, scale=0.125, window=window)
    assert fn.launches == before + 1
    assert _path_counts(fn) == (paths[0] + tensor_core, paths[1] + (not tensor_core))
    want = PA.paged_attention_int8_reference(q, kc, ks, vc, vs, bt, lens, scale=0.125,
                                             window=window)
    assert got.dtype == qdtype and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) < atol


@pytest.mark.parametrize("kv", ["bf16", "int8", "float32"])
@pytest.mark.parametrize("b,hq,hkv,d,page,nb,lens", [
    (4, 32, 16, 128, 16, 128, [309, 709, 1109, 1509]),
    (8, 32, 16, 128, 16, 256, [0, 4096, 1839, 3185, 719, 1912, 1049, 96])])
@pytest.mark.parametrize("window", [0, 1024])
def test_paged_attention_repeat_is_bit_identical(gen, kv, b, hq, hkv, d, page, nb, lens, window):
    """Two calls on the same inputs give the same bits: the split plan reads
    shapes only and the splits merge in a fixed order, with no atomics in the
    sums, on both paths."""
    dtype = torch.float32 if kv == "float32" else torch.bfloat16
    PA, q, k, v, bt, lens = _paged_case(gen, b, hq, hkv, d, page, nb, dtype, lens)
    if kv == "int8":
        kc, ks = PA.quantize_kv_rows(k)
        vc, vs = PA.quantize_kv_rows(v)
        call = lambda: PA.paged_attention_int8_cuda(  # noqa: E731
            q, kc, ks, vc, vs, bt, lens, scale=0.1, window=window)
    else:
        call = lambda: PA.paged_attention_cuda(q, k, v, bt, lens, scale=0.1,  # noqa: E731
                                               window=window)
    first, second = call(), call()
    assert torch.equal(first, second)


@pytest.mark.parametrize("lengths,window,total", [
    ([309, 709, 1109, 1509], 0, 2048),          # the decode step, global and sliding layers
    ([309, 709, 1109, 1509], 1024, 2048),
    ([0, 4096, 1839, 3185, 719, 1912, 1049, 96], 0, 4096),   # phase 2's case
    ([0, 0, 0], 0, 64),                         # inactive slots only
    ([1, 2048, 5, 0], 1024, 2048),
    ([24, 100_000, 777, 3], 50_000, 100_000),   # long ranges that start mid-table
])
@pytest.mark.parametrize("splits", [1, 3, 4, 9])
def test_paged_attention_deal_covers_every_token_once(gen, lengths, window, total, splits):
    """The kernels' own deal of a kv head's B * splits blocks: every slot gets
    one block, in slot order, and of the other B * (splits - 1) blocks its
    share of the rows all slots read (2 a needed token; an empty slot its
    ``total`` V rows) within one block; a slot's blocks cut its needed range
    (all ``total`` tokens for an empty slot) into near-equal runs of whole
    16-token steps, with no gap and no overlap."""
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    deal = PA.deal_cuda(lens, window=window, total=total, splits=splits)
    assert torch.equal(deal, PA.deal_cuda(lens, window=window, total=total, splits=splits))
    rows = deal.cpu().tolist()
    slots = [r[0] for r in rows]
    assert slots == sorted(slots) and set(slots) == set(range(len(lengths)))

    def needed(n):
        lo, hi = (max(0, n - window) if window else 0), min(n, total)
        return (lo, hi) if n and lo < hi else (0, total)

    reads = [2 * (hi - lo) if n and lo < hi else total
             for n, (lo, hi) in zip(lengths, map(needed, lengths))]
    extra = len(lengths) * (splits - 1)
    for slot, n in enumerate(lengths):
        lo, hi = needed(n)
        live = [(a, e) for b, a, e in rows if b == slot and a < e]
        assert abs(slots.count(slot) - 1 - reads[slot] * extra / sum(reads)) < 1
        assert live[0][0] == lo and live[-1][1] == hi
        assert all(e0 == a1 for (_, e0), (a1, _) in zip(live, live[1:]))   # no gap, no overlap
        assert all((a - lo) % PA.STEP == 0 for a, _ in live)
        assert all((e - a) % PA.STEP == 0 for a, e in live[:-1])
        steps = [-(-(e - a) // PA.STEP) for a, e in live]
        assert max(steps) - min(steps) <= 1                          # near-equal parts


def test_paged_attention_two_streams_share_nothing(gen):
    """Calls in flight together on two streams, one of them a CUDA graph
    replay, each give the bits of a lone call: each call's split merge counts
    arrivals in its own buffer."""
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    shape = (4, 32, 16, 128, 16, 128, torch.bfloat16)
    _, q1, k1, v1, bt1, lens1 = _paged_case(gen, *shape, [309, 709, 1109, 1509])
    _, q2, k2, v2, bt2, lens2 = _paged_case(gen, *shape, [1509, 5, 0, 2048])
    call1 = lambda: PA.paged_attention_cuda(q1, k1, v1, bt1, lens1, scale=0.1)  # noqa: E731
    call2 = lambda: PA.paged_attention_cuda(q2, k2, v2, bt2, lens2, scale=0.1,  # noqa: E731
                                            window=1024)
    want1, want2 = call1(), call2()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    s1.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        with torch.cuda.graph(graph, stream=s1):
            got1 = call1()
    torch.cuda.synchronize()
    s2.wait_stream(torch.cuda.current_stream())
    outs1, outs2 = [], []
    for _ in range(20):
        with torch.cuda.stream(s1):
            graph.replay()
            outs1.append(got1.clone())
        with torch.cuda.stream(s2):
            outs2.append(call2())
    torch.cuda.synchronize()
    assert all(torch.equal(o, want1) for o in outs1)
    assert all(torch.equal(o, want2) for o in outs2)


def test_quantize_kv_rows_on_card_equals_cpu(gen):
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    x = _randn(gen, 5, 16, 4, 128, dtype=torch.bfloat16) * 7
    x[0, 0, 0] = 0
    c, s = PA.quantize_kv_rows(x)
    c_cpu, s_cpu = PA.quantize_kv_rows(x.cpu())
    assert torch.equal(c.cpu(), c_cpu) and torch.equal(s.cpu(), s_cpu)


# -- K8a / K8b: int8 weight products ----------------------------------------------

@pytest.mark.parametrize("m,k,n", [
    (1, 512, 1024), (4, 5376, 4096), (8, 5376, 2048), (16, 96, 80), (3, 96, 80),
    (5, 40, 24), (17, 200, 300), (300, 512, 384), (8, 21504, 5376), (513, 136, 257),
    (130, 96, 80), (40, 5376, 2048), (6, 37, 50), (20, 37, 50), (7, 1000, 130),
    # K8a's prefill tile at gemma-3-27b's shapes: one token tile, 4 (split K), 12
    (64, 5376, 4096), (512, 5376, 21504), (1504, 21504, 5376)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernels_match_plain(gen, m, k, n, out):
    """K8a and K8b against their plain versions on the same bf16 inputs:
    within 2% of the output's largest value (tests/test_quant.py:195-217);
    ragged M, N and K included, and rows that are not whole 16-byte chunks
    (K = 37: x too; K = 40, 200, 1000: K8b's codes; N = 24, 50, 257, 300:
    K8a's). K8a takes its decode tile for M <= 16, its prefill tile above."""
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    x = _randn(gen, m, k, dtype=torch.bfloat16)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    codes_t = torch.randint(-127, 128, (n, k), generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01
    kn = IM.int8_matmul_kn_cuda
    tiles = (kn.decode_launches, kn.prefill_launches)
    for fn, counter, c, t in ((IM.int8_matmul_kn, kn, codes, False),
                              (IM.int8_matmul_nk, IM.int8_matmul_nk_cuda, codes_t, True)):
        before = counter.launches
        got = fn(x, c, scale, out_dtype=out)
        assert counter.launches == before + 1
        want = IM.int8_matmul_reference(x.float(), c, scale, transpose_codes=t)
        assert got.dtype == out and got.shape == (m, n)
        assert float((got.float() - want).abs().max()) <= 0.02 * float(want.abs().max())
    assert (kn.decode_launches - tiles[0], kn.prefill_launches - tiles[1]) == \
        ((1, 0) if m <= 16 else (0, 1))


@pytest.mark.parametrize("m,k,n", [
    (1, 5376, 1024), (8, 5376, 1000), (16, 96, 40), (17, 384, 264), (200, 512, 300),
    (512, 5376, 1024), (1504, 2048, 512), (300, 37, 50)])
def test_int8_matmul_kernel_exact_on_grid_inputs(gen, m, k, n):
    """Integer codes, x on a 2^-4 grid (|x| <= 1/2) and a power-of-two scale:
    every product and partial sum is exact in float32, so both K8a tiles equal
    the float32 plain product bit for bit; one that paired the wrong rows,
    columns or tokens could not."""
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    codes = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    x = (torch.randint(-8, 8, (m, k), generator=gen, device="cuda") * 0.0625).to(torch.bfloat16)
    scale = torch.full((n,), 2.0 ** -7, device="cuda")
    got = IM.int8_matmul_kn_cuda(x, codes, scale, out_dtype=torch.float32)
    assert torch.equal(got, IM.int8_matmul_reference(x.float(), codes, scale))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n,group", [
    (300, 5376, 2048, 256), (512, 21504, 5376, 256), (1504, 5376, 1024, 256),
    (200, 512, 300, 64), (130, 192, 136, 16)])
def test_prefill_tiles_repeat_bit_identical(gen, kind, m, k, n, group):
    """K8a's and K9's prefill tile give the same bits on a repeated call,
    split K (512 x 5376 output: 3 splits) or not, grouped or gathered (K9 at
    G = 16); each call counts one prefill launch (and, gathered, one
    gathered launch)."""
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    x = _randn(gen, m, k, dtype=torch.bfloat16)
    if kind == "int8":
        fn = IM.int8_matmul_kn_cuda
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
        s = torch.rand(n, generator=gen, device="cuda") * 0.01
    else:
        fn = I4.int4_matmul_kn_cuda
        w, s = _int4_case(gen, k, n, group)
    before = (fn.decode_launches, fn.prefill_launches)
    gathered = getattr(fn, "gathered_launches", 0)
    a = fn(x, w, s, out_dtype=torch.float32)
    assert torch.equal(a, fn(x, w, s, out_dtype=torch.float32))
    assert (fn.decode_launches, fn.prefill_launches) == (before[0], before[1] + 2)
    if kind == "int4":
        assert fn.gathered_launches - gathered == 2 * I4.gathers(m, group)


def test_int8_matmul_rejects_float32_x(gen):
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    with pytest.raises(TypeError):
        IM.int8_matmul_kn_cuda(_randn(gen, 2, 32), torch.zeros(32, 16, dtype=torch.int8,
                                                               device="cuda"),
                               torch.ones(16, device="cuda"))


@pytest.mark.parametrize("nk", [False, True])
def test_int8_matmul_kernel_takes_unaligned_views(gen, nk):
    """Contiguous views that start off a 16-byte boundary are copied element
    by element, not by cp.async, and give the aligned result."""
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    m, k, n = 6, 256, 384
    x = _randn(gen, m, k, dtype=torch.bfloat16)
    codes = torch.randint(-127, 128, ((n, k) if nk else (k, n)), generator=gen,
                          device="cuda").to(torch.int8)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01
    x_off = torch.empty(m * k + 1, dtype=torch.bfloat16, device="cuda")[1:].view(m, k)
    c_off = torch.empty(codes.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(codes.shape)
    x_off.copy_(x)
    c_off.copy_(codes)
    assert x_off.data_ptr() % 16 and c_off.data_ptr() % 16
    fn = IM.int8_matmul_nk_cuda if nk else IM.int8_matmul_kn_cuda
    assert torch.equal(fn(x_off, c_off, scale), fn(x, codes, scale))


def test_int8_engine_on_card_takes_k8_and_matches_cpu(gen):
    """A tiny Gemma-3 int8 engine in bf16 runs every projection as K8a and
    the tied head as K8b on the card, and its greedy stream agrees with the
    same engine's plain versions on the CPU up to near-ties."""
    from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
    from multimodal_colpali_tpu_torch.models.configs import Gemma3TextConfig
    from multimodal_colpali_tpu_torch.models.registry import gemma3_random_params
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    cfg = Gemma3TextConfig.tiny(vocab_size=64)
    params = gemma3_random_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    card = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, weight_dtype="int8",
                             device="cuda")
    before = (IM.int8_matmul_kn_cuda.launches, IM.int8_matmul_nk_cuda.launches)
    logits = card.next_token_logits([[5, 9, 17, 3], [40, 2]])
    assert IM.int8_matmul_kn_cuda.launches > before[0]
    assert IM.int8_matmul_nk_cuda.launches > before[1]
    cpu = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, weight_dtype="int8",
                            device="cpu")
    want = cpu.next_token_logits([[5, 9, 17, 3], [40, 2]])
    assert logits.shape == want.shape == (2, 64)
    assert float(abs(logits - want).max()) < 0.05 * float(abs(want).max()) + 1e-3


def test_paged_batcher_on_card_takes_k7(gen):
    """The paged batcher's decode runs K7a (native pools) and K7b (int8
    pools) on the card; greedy streams agree with the bare engine's."""
    from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
    from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
    from multimodal_colpali_tpu_torch.models.configs import Gemma3TextConfig
    from multimodal_colpali_tpu_torch.models.registry import gemma3_random_params
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    cfg = Gemma3TextConfig.tiny(vocab_size=64)
    eng = GemmaDecodeEngine(cfg, gemma3_random_params(cfg, seed=2, dtype=torch.float32,
                                                      device="cuda"), device="cuda")
    prompts = [[5, 9, 17, 3], list(range(3, 24))]
    want = eng.generate(prompts, max_new_tokens=10)
    for kv, counter in (("native", PA.paged_attention_cuda), ("int8", PA.paged_attention_int8_cuda)):
        before = counter.launches
        bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8,
                                     kv_dtype=kv)
        got = bat.generate(prompts, max_new_tokens=10)
        assert counter.launches > before
        if kv == "native":
            assert got == want
        else:
            assert [g[:3] for g in got] == [w[:3] for w in want]


# -- K6: window attention ------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,s,d", [
    (7, 144, 32), (130, 144, 32),           # ColFlor's windows, ragged N
    (5, 37, 20), (3, 7, 100), (64, 16, 8),  # S and D that need masking
    (2, 200, 64), (1, 1, 1), (4, 144, 128)])
def test_window_attention_kernel_matches_plain(gen, dtype, tol, n, s, d):
    """K6 against its plain version on the same inputs: bf16 within atol and
    rtol 2e-2 (P and the output round to bf16 at the same points; the sums
    run in another order), float32 within 1e-5."""
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    q, k, v = (_randn(gen, n, s, d, dtype=dtype) for _ in range(3))
    before = WA.window_attention_cuda.launches
    got = WA.window_attention(q, k, v, scale=d ** -0.5)
    assert WA.window_attention_cuda.launches == before + 1
    want = WA.window_attention_reference(q, k, v, scale=d ** -0.5)
    assert got.dtype == dtype and got.shape == (n, s, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _ring_case(gen, n, s, d, scale=None):
    """One launch on the ring kernel against the plain version: bf16 within
    atol and rtol 2e-2, the ring counter up by one."""
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    q, k, v = (_randn(gen, n, s, d, dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5 if scale is None else scale
    before = WA.window_attention_cuda.ring_launches
    got = WA.window_attention_cuda(q, k, v, scale=scale)
    assert WA.window_attention_cuda.ring_launches == before + 1
    want = WA.window_attention_reference(q, k, v, scale=scale)
    assert got.shape == (n, s, d) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    return (q, k, v), got


@pytest.mark.parametrize("n", [256, 192, 160, 128], ids=["stage0", "stage1", "stage2", "stage3"])
def test_window_attention_ring_at_colflor_stage_shapes(gen, n):
    """ColFlor's four DaViT stages ([8192 | 4096 | 2048 | 1024, 144, 32] at
    batch 8), N cut to a few hundred."""
    _ring_case(gen, n, 144, 32)


@pytest.mark.parametrize("where", ["one", "grid-1", "grid+1", "two_grids+5"])
def test_window_attention_ring_windows_around_the_grid(gen, where):
    """Persistent blocks: N of 1, one short of the grid, one past it, and
    more than two windows a block."""
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    grid = WA.ring_grid()
    assert grid >= torch.cuda.get_device_properties(0).multi_processor_count
    n = {"one": 1, "grid-1": grid - 1, "grid+1": grid + 1, "two_grids+5": 2 * grid + 5}[where]
    _ring_case(gen, n, 144, 32)


@pytest.mark.parametrize("s", [16, 49, 144])
@pytest.mark.parametrize("d", [16, 24, 32])
def test_window_attention_ring_window_and_head_sizes(gen, s, d):
    """S of one key tile, a ragged 7 x 7 window and ColFlor's 12 x 12; D of
    16 and 24, whose columns past D read as zeros from the tensor map."""
    _ring_case(gen, 37, s, d)


@pytest.mark.parametrize("scale", [-0.2, 0.0, 1e-3])
def test_window_attention_ring_scales(gen, scale):
    """Full 12 x 12 windows with a scale that is not positive take the masked
    softmax (the fast one folds a positive scale into the exponent); a tiny
    positive scale takes the fast one."""
    _ring_case(gen, 37, 144, 32, scale=scale)


def test_window_attention_ring_repeat_is_bit_identical_and_captures(gen):
    """A repeated call gives the same bits, and so does a CUDA-graph replay
    of the launch (its grid and tensor maps come from shapes alone)."""
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    qkv, first = _ring_case(gen, 300, 144, 32)
    again = WA.window_attention_cuda(*qkv, scale=32 ** -0.5)
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = WA.window_attention_cuda(*qkv, scale=32 ** -0.5)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), out.view(torch.int16))


@pytest.mark.parametrize("d", [32, 20])
def test_window_attention_ring_misaligned_view(gen, d):
    """q, k and v as storage-offset views whose pointers are not 16-byte
    aligned (and D = 20, rows not of whole 16-byte chunks) take the element
    copies inside the ring kernel, with the aligned inputs' bits."""
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    n, s = 40, 144
    views = []
    for _ in range(3):
        flat = _randn(gen, n * s * d + 1, dtype=torch.bfloat16)
        views.append(flat[1:].view(n, s, d))
    assert all(x.data_ptr() % 16 for x in views)
    before = WA.window_attention_cuda.ring_launches
    got = WA.window_attention_cuda(*views, scale=0.2)
    assert WA.window_attention_cuda.ring_launches == before + 1
    want = WA.window_attention_cuda(*(x.clone() for x in views), scale=0.2)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    ref = WA.window_attention_reference(*views, scale=0.2)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_window_attention_kernel_refuses_what_it_cannot_take(gen):
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    before = WA.window_attention_cuda.launches
    big = _randn(gen, 1, 600, 32, dtype=torch.bfloat16)       # S past 512
    with pytest.raises(RuntimeError, match="window_attention_launch"):
        WA.window_attention_cuda(big, big, big, scale=0.1)
    half = _randn(gen, 2, 16, 8, dtype=torch.float16)
    with pytest.raises(TypeError):
        WA.window_attention_cuda(half, half, half, scale=0.1)
    assert WA.window_attention_cuda.launches == before


def test_colflor_on_card_takes_k6_and_never_k2(gen, monkeypatch):
    """A tiny float32 ColFlor runs its windows as K6 on the card, launches no
    K2, and agrees with the same model on the CPU (float32 convolutions with
    TF32 off)."""
    import copy

    from multimodal_colpali_tpu_torch.models.configs import ColFlorModelConfig
    from multimodal_colpali_tpu_torch.models.florence2 import ColFlorModel
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = ColFlorModelConfig.tiny()
    cpu = ColFlorModel(cfg, device="cpu", dtype=torch.float32).eval()
    init_random_params_(cpu, seed=3, family="colflor")
    card = copy.deepcopy(cpu).to("cuda")
    ids = torch.tensor([[cfg.image_token_id] * 17 + [5, 9, 11]] * 2)
    mask = torch.ones_like(ids)
    pix = torch.randn(2, 40, 40, 3, generator=torch.Generator().manual_seed(4))  # windows pad
    before = (WA.window_attention_cuda.launches, A.fused_attention_cuda.launches)
    with torch.inference_mode():
        got = card(ids.cuda(), mask.cuda(), pix.cuda())
        want = cpu(ids, mask, pix)
    assert WA.window_attention_cuda.launches == before[0] + sum(cfg.vision.depths)
    assert A.fused_attention_cuda.launches == before[1]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# -- K9: group-wise int4 weight products ---------------------------------------------

def _int4_case(gen, k, n, group):
    packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
    scale = torch.rand(k // group, n, generator=gen, device="cuda") * 0.01
    return packed, scale


@pytest.mark.parametrize("m,k,n,group", [
    (1, 512, 1024, 256), (4, 5376, 2048, 256), (8, 21504, 640, 256), (16, 96, 80, 16),
    (3, 96, 80, 16), (5, 64, 40, 16), (17, 128, 300, 64), (300, 512, 384, 256),
    (513, 256, 257, 64), (40, 5376, 2048, 256), (6, 40, 50, 2), (20, 192, 136, 64)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_int4_matmul_kernel_matches_plain(gen, m, k, n, group, out):
    """K9 against its plain version on the same bf16 inputs: within 2% of the
    output's largest value (K8's limit); ragged M, N and K, groups of 2 to 256
    (steps that cross groups gather x element by element)."""
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4

    x = _randn(gen, m, k, dtype=torch.bfloat16)
    packed, scale = _int4_case(gen, k, n, group)
    before = I4.int4_matmul_kn_cuda.launches
    got = I4.int4_matmul_kn(x, packed, scale, out_dtype=out)
    assert I4.int4_matmul_kn_cuda.launches == before + 1
    want = I4.int4_matmul_reference(x.float(), packed, scale)
    assert got.dtype == out and got.shape == (m, n)
    assert float((got.float() - want).abs().max()) <= 0.02 * float(want.abs().max())


@pytest.mark.parametrize("m,k,n,group", [
    (8, 5376, 1024, 256), (3, 96, 80, 16), (200, 512, 300, 64),
    # the decode tile at M = 1, 9, 16: ragged N, split or single K, G/2 odd
    (1, 5376, 1000, 256), (9, 5376, 1000, 256), (16, 96, 40, 2), (16, 384, 264, 64)])
def test_int4_matmul_kernel_exact_on_grid_weights(gen, m, k, n, group):
    """codes x 2^-3 and x on a 2^-4 grid: every product and partial sum is
    exact in float32, so K9 equals the plain version bit for bit; a kernel
    that read the nibbles, columns or slots in another order could not."""
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops.quant import quantize_int4

    codes = torch.randint(-7, 8, (k, n), generator=gen, device="cuda").float()
    codes[::group] = 7.0                       # saturate every (group, column): scale 2^-3
    q = quantize_int4(codes * 0.125, group=group)
    x = (torch.randint(-128, 128, (m, k), generator=gen, device="cuda") * 0.0625).to(
        torch.bfloat16)
    got = I4.int4_matmul_kn_cuda(x, q["q4"], q["scale"], out_dtype=torch.float32)
    assert torch.equal(got, I4.int4_matmul_reference(x.float(), q["q4"], q["scale"]))


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("k,n,group", [(5376, 1000, 256), (512, 1000, 64), (96, 1000, 2),
                                       (21504, 512, 256)])
def test_int4_decode_tile_matches_plain_and_repeats(gen, m, k, n, group):
    """The decode tile (M <= 16, weights dequantized in registers): within 2%
    of the output's largest value, ragged N, groups of 2 to 256 (odd G/2
    splits a lane's byte-row pair across groups), split-K or not; two calls on
    the same inputs give the same bits."""
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4

    x = _randn(gen, m, k, dtype=torch.bfloat16)
    packed, scale = _int4_case(gen, k, n, group)
    before = (I4.int4_matmul_kn_cuda.decode_launches, I4.int4_matmul_kn_cuda.prefill_launches)
    got = I4.int4_matmul_kn_cuda(x, packed, scale)
    assert I4.int4_matmul_kn_cuda.decode_launches == before[0] + 1
    assert I4.int4_matmul_kn_cuda.prefill_launches == before[1]
    want = I4.int4_matmul_reference(x.float(), packed, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert float((got.float() - want).abs().max()) <= 0.02 * float(want.abs().max())
    again = I4.int4_matmul_kn_cuda(x, packed, scale, out_dtype=torch.float32)
    assert torch.equal(again, I4.int4_matmul_kn_cuda(x, packed, scale, out_dtype=torch.float32))
    assert torch.equal(again.to(torch.bfloat16), got)


@pytest.mark.parametrize("m,n,group", [(6, 384, 64), (12, 1000, 256)])
def test_int4_matmul_kernel_takes_unaligned_views(gen, m, n, group):
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4

    k = 256 if group == 64 else 512
    x = _randn(gen, m, k, dtype=torch.bfloat16)
    packed, scale = _int4_case(gen, k, n, group)
    x_off = torch.empty(m * k + 1, dtype=torch.bfloat16, device="cuda")[1:].view(m, k)
    p_off = torch.empty(packed.numel() + 1, dtype=torch.uint8, device="cuda")[1:].view(k // 2, n)
    s_off = torch.empty(scale.numel() + 1, device="cuda")[1:].view(scale.shape)
    x_off.copy_(x)
    p_off.copy_(packed)
    s_off.copy_(scale)
    assert x_off.data_ptr() % 16 and p_off.data_ptr() % 16 and s_off.data_ptr() % 16
    assert torch.equal(I4.int4_matmul_kn_cuda(x_off, p_off, s_off),
                       I4.int4_matmul_kn_cuda(x, packed, scale))


def test_int4_matmul_rejects_odd_groups_and_float32_x(gen):
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4

    packed, scale = _int4_case(gen, 48, 16, 16)
    with pytest.raises(TypeError):
        I4.int4_matmul_kn_cuda(_randn(gen, 2, 48), packed, scale)
    with pytest.raises(ValueError, match="even"):
        I4.int4_matmul_kn_cuda(_randn(gen, 2, 48, dtype=torch.bfloat16), packed,
                               torch.ones(16, 16, device="cuda"))       # group 3


def test_int4_engine_on_card_takes_k9_and_k8b(gen):
    """A tiny Gemma-3 int4 engine in bf16 runs every projection as K9 and the
    tied head (an int8 table) as K8b on the card, and its logits agree with
    the same engine's plain versions on the CPU."""
    from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
    from multimodal_colpali_tpu_torch.models.configs import Gemma3TextConfig
    from multimodal_colpali_tpu_torch.models.registry import gemma3_random_params
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    cfg = Gemma3TextConfig.tiny(vocab_size=64)
    params = gemma3_random_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    card = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, weight_dtype="int4",
                             device="cuda")
    before = (I4.int4_matmul_kn_cuda.launches, IM.int8_matmul_nk_cuda.launches,
              IM.int8_matmul_kn_cuda.launches)
    logits = card.next_token_logits([[5, 9, 17, 3], [40, 2]])
    assert I4.int4_matmul_kn_cuda.launches == before[0] + 7 * cfg.num_hidden_layers
    assert IM.int8_matmul_nk_cuda.launches > before[1]
    assert IM.int8_matmul_kn_cuda.launches == before[2]
    cpu = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, weight_dtype="int4",
                            device="cpu")
    want = cpu.next_token_logits([[5, 9, 17, 3], [40, 2]])
    assert logits.shape == want.shape == (2, 64)
    assert float(abs(logits - want).max()) < 0.05 * float(abs(want).max()) + 1e-3


# -- the dense RAG path: BERT and the dense store run no port kernel ----------------------

def test_bge_base_on_card_launches_no_port_kernel(gen):
    """A bge-base forward (BERT-base at full width, bf16) on the card takes
    the plain einsum attention (its key-padding mask) and cuBLAS products:
    no port kernel's counter rises. Its embeddings are unit-norm and agree
    with a float32 forward of the same weights; the dense store on the card
    returns the CPU store's ids."""
    import warnings

    from multimodal_colpali_tpu_torch.models.bert import BertEncoder
    from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA
    from multimodal_colpali_tpu_torch.ops import window_attention as WA
    from multimodal_colpali_tpu_torch.store import DenseVectorStore, PointStruct

    wrappers = [M.maxsim_scores_cuda, M.maxsim_scores_int8_cuda, A.fused_attention_cuda,
                PP.normalize_images_cuda, FL.fused_vit_layer_cuda,
                FL.fused_vit_attention_block_cuda, FL.fused_mlp_block_cuda, FL.fused_gemm_cuda,
                FL.ln_stats_cuda, PA.paged_attention_cuda, PA.paged_attention_int8_cuda,
                IM.int8_matmul_kn_cuda, IM.int8_matmul_nk_cuda, WA.window_attention_cuda,
                I4.int4_matmul_kn_cuda]
    before = [w.launches for w in wrappers]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        emb = BgeEmbeddings(device="cuda", seed=1)
    texts = ["glycans bind lectins " * k for k in (1, 20, 100)] + ["sialyl Lewis x"]
    vecs = np.asarray(emb.embed_documents(texts), np.float32)
    f32 = BertEncoder(emb.cfg, device="cuda", dtype=torch.float32)
    f32.load_state_dict(emb.model.state_dict())
    ids, mask = emb._tokenize(texts)
    with torch.inference_mode():
        ref = f32(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu().numpy()
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0, atol=1e-3)
    cos = np.sum(ref * vecs, -1) / np.linalg.norm(ref, axis=-1) / np.linalg.norm(vecs, axis=-1)
    assert cos.min() >= 0.995

    rng = np.random.default_rng(2)
    corpus = rng.standard_normal((1001, 768)).astype(np.float32)
    stores = [DenseVectorStore("d", device=dev) for dev in ("cuda", "cpu")]
    for s in stores:
        s.upsert([PointStruct(id=i, vector=corpus[i]) for i in range(len(corpus))])
    q = corpus[17] + 0.5 * rng.standard_normal(768).astype(np.float32)
    got, want = (s.query(q, limit=10).points for s in stores)
    assert [p.id for p in got] == [p.id for p in want] and got[0].id == 17
    np.testing.assert_allclose([p.score for p in got], [p.score for p in want], rtol=1e-5,
                               atol=1e-6)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before


# -- ingest (the resample, ConvOcr, create_document_embeddings) ---------------------------

def test_float64_resample_on_card_equals_host_int64(gen):
    """``imageops.resize`` on a CUDA tensor (float64 banded sums) is bit-equal
    to the host int64 path, for every filter, up and down, RGB and gray."""
    from multimodal_colpali_tpu_torch.ingest import imageops

    rng = np.random.default_rng(0)
    page = rng.integers(0, 256, (1584, 1224, 3)).astype(np.uint8)
    page[::7] = 255
    cases = [((1005, 1300), "lanczos"), ((448, 448), "bicubic"), ((2448, 3168), "bilinear"),
             ((13, 1700), "lanczos"), ((1224, 77), "bicubic")]
    for size, name in cases:
        host = imageops.resize(page, size, name)
        dev = imageops.resize(torch.from_numpy(page).cuda(), size, name)
        assert dev.is_cuda and dev.dtype == torch.uint8
        assert np.array_equal(dev.cpu().numpy(), host), (size, name)
    gray = page[..., 0].copy()
    assert np.array_equal(imageops.resize(torch.from_numpy(gray).cuda(), (300, 500),
                                          "bilinear").cpu().numpy(),
                          imageops.resize(gray, (300, 500), "bilinear"))


def test_conv_ocr_on_card_reads_as_on_cpu(gen, tmp_path):
    """ConvOcr's classifier on the card (TF32 off) gives the CPU's text, and
    logits within 1e-4 on the same glyphs."""
    from multimodal_colpali_tpu_torch.ingest.ocr_conv import ConvOcr
    from multimodal_colpali_tpu_torch.ingest.pdfwrite import PdfWriter
    from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument

    src = PdfWriter()
    src.add_page(text_lines=["Glycans bind selectins on cells 42", "second line of text"],
                 font_size=14)
    page = PdfDocument(src.tobytes()).render(0, dpi=288.0)
    cpu, card = ConvOcr(device="cpu"), ConvOcr(device="cuda")
    assert card.recognize(page, return_score=True)[0] == cpu.recognize(page)
    assert card.recognize_runs(page, dpi=288.0) == cpu.recognize_runs(page, dpi=288.0)
    rng = np.random.default_rng(1)
    patches = rng.uniform(0, 1, (64, 20, 20)).astype(np.float32)
    feats = rng.normal(0, 1, (64, 6)).astype(np.float32)
    np.testing.assert_allclose(card._forward(patches, feats), cpu._forward(patches, feats),
                               rtol=0, atol=1e-4)


def test_create_document_embeddings_on_card_launches_k2_and_k3(gen, tmp_path):
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.ingest.pdfwrite import make_sample_pdf
    from multimodal_colpali_tpu_torch.ingest.pipeline import PipelinedEmbedder
    from multimodal_colpali_tpu_torch.ingest.rasterize import convert_pdf_dir_to_images
    from multimodal_colpali_tpu_torch.models import load_retriever

    for i in range(2):
        make_sample_pdf(str(tmp_path / f"p{i}.pdf"), n_pages=2, lines_per_page=6, seed=i)
    with pytest.warns(UserWarning, match="random init"):
        r = load_retriever("tiny-colpali", device="cuda", device_preprocess=True)
    k2, k3 = A.fused_attention_cuda.launches, PP.normalize_images_cuda.launches
    seq = api.create_document_embeddings(str(tmp_path), r, batch_size=2)
    assert A.fused_attention_cuda.launches > k2 and PP.normalize_images_cuda.launches > k3
    pipe = PipelinedEmbedder(r, batch_size=3).embed_pdf_dir(str(tmp_path))
    assert len(seq) == len(pipe) == 4
    for a, b in zip(seq, pipe):
        assert (a["doc_id"], a["page_id"], a["file_name"]) == \
            (b["doc_id"], b["page_id"], b["file_name"])
        np.testing.assert_allclose(a["embedding"], b["embedding"], rtol=0, atol=2e-2)
    # the pages as the CPU resizes them: the same pixels reach the processor
    cpu = convert_pdf_dir_to_images(str(tmp_path), device="cpu")
    card = convert_pdf_dir_to_images(str(tmp_path), device="cuda")
    for name in cpu:
        for a, b in zip(cpu[name], card[name]):
            assert b.is_cuda and np.array_equal(b.cpu().numpy(), a)


def test_processors_on_card_give_the_host_pixels(gen):
    """A processor given the card resizes and normalizes there: the pixels
    equal the host's bit for bit (every byte value in each channel, pages
    at and off the model size), for ColPali's [-1, 1], ColSmol's and
    ColFlor's ImageNet statistics, float32 and uint8."""
    from multimodal_colpali_tpu_torch.models.configs import (
        ColFlorModelConfig, ColIdefics3ModelConfig, ColPaliModelConfig)
    from multimodal_colpali_tpu_torch.models.processing import ColPaliProcessor
    from multimodal_colpali_tpu_torch.models.processing_florence2 import ColFlorProcessor
    from multimodal_colpali_tpu_torch.models.processing_idefics3 import ColIdefics3Processor

    rng = np.random.default_rng(2)
    for proc in (ColPaliProcessor(ColPaliModelConfig.tiny()),
                 ColIdefics3Processor(ColIdefics3ModelConfig.tiny()),
                 ColFlorProcessor(ColFlorModelConfig.tiny())):
        size = (proc.cfg.image_size if isinstance(proc, ColFlorProcessor)
                else proc.image_preprocessor.image_size)
        ramp = np.arange(size * size * 3) % 256
        pages = [ramp.astype(np.uint8).reshape(size, size, 3),
                 rng.integers(0, 256, (size + 37, size // 2 + 5, 3), dtype=np.uint8)]
        host = proc.process_images(pages)["pixel_values"]
        card = proc.process_images(pages, device="cuda")["pixel_values"]
        assert card.is_cuda and card.dtype == torch.float32
        assert np.array_equal(card.cpu().numpy(), host), type(proc).__name__
        if not isinstance(proc, ColFlorProcessor):
            host = proc.process_images(pages, device_preprocess=True)["pixel_values"]
            card = proc.process_images(pages, device_preprocess=True, device="cuda")
            assert np.array_equal(card["pixel_values"].cpu().numpy(), host)


def test_pdf_loader_figures_resize_on_card(gen, tmp_path):
    """pdf_loader's figure PNGs, resized by ``resize_image`` on the card (a
    JPEG figure wider than 1,300 px, decoded by the port's decoder, and a
    Flate one narrower than 224), are the CPU's pixels."""
    import importlib

    from multimodal_colpali_tpu_torch.ingest import pdfwrite
    from multimodal_colpali_tpu_torch.ingest.imageops import read_png
    from multimodal_colpali_tpu_torch.ingest.rasterize import encode_jpeg
    from multimodal_colpali_tpu_torch.models.processing import SimpleTokenizer

    loader = importlib.import_module("multimodal_colpali_tpu_torch.ingest.pdf_loader")
    rng = np.random.default_rng(3)
    w = pdfwrite.PdfWriter()
    big = rng.integers(0, 256, (1000, 1500, 3), dtype=np.uint8)
    w.add_page(text_lines=["a large JPEG figure"], image=encode_jpeg(big, 85))
    w.add_page(text_lines=["a small figure"],
               image=rng.integers(0, 256, (40, 180, 3), dtype=np.uint8))
    pdf = str(tmp_path / "figs.pdf")
    w.save(pdf)
    pngs = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        loader.pdf_loader([pdf], [""], ["figs.pdf"], str(out), SimpleTokenizer(1000, 999),
                          device=dev)
        pngs[dev] = sorted((out / "images").iterdir())
    assert [p.name for p in pngs["cpu"]] == [p.name for p in pngs["cuda"]] and len(pngs["cpu"]) == 2
    for a, b in zip(pngs["cpu"], pngs["cuda"]):
        assert np.array_equal(read_png(a), read_png(b)), a.name
    assert read_png(pngs["cpu"][0]).shape[:2] == (867, 1300)


@pytest.mark.parametrize("form", ["windows", "full"])
def test_attention_at_the_colqwen25_tower_shapes(gen, form):
    """K2 at D = 80, ColQwen2.5's tower at the 54 x 54 bucket for 2 pages:
    its 49 windows of 64 patches folded into the batch with each window's
    ``kv_lens`` (edge windows hold 32 or 16 real patches), ``[98, 64, 16,
    80]``, and its full blocks over the padded 3,136 patches with
    ``kv_valid`` (2,916 real keys), ``[2, 3136, 16, 80]``. The tensor-core
    path against the plain version, a repeat bit-identical."""
    from multimodal_colpali_tpu_torch.models.configs import ColQwen2ModelConfig
    from multimodal_colpali_tpu_torch.models.qwen2vl import window_layout

    cfg = ColQwen2ModelConfig.colqwen2_5_v0_2()
    lay = window_layout(cfg.vision, 54, 54)
    b = 2
    if form == "windows":
        n_win, w = lay["win"]
        assert (n_win, w) == (49, 64)
        shape = (b * n_win, w, 16, 80)
        kw = {"kv_lens": torch.from_numpy(lay["win_lens"]).cuda().repeat(b)}
    else:
        valid = torch.from_numpy(lay["full_valid"]).cuda()
        assert valid.numel() == 3136 and int(valid.sum()) == 2916
        shape = (b, 3136, 16, 80)
        kw = {"kv_valid": valid[None].expand(b, -1)}
    q, k, v = (_randn(gen, *shape, dtype=torch.bfloat16) for _ in range(3))
    before = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(q, k, v, scale=80 ** -0.5, **kw)
    # a window averages 16-64 values (outputs up to ~3, where a bf16 step is
    # 2^-6): within 2^-7 |want| + 2^-8 (P |V|) an element, twice the bf16
    # roundings of the outputs and of P, and within 2e-2; a full block
    # 2,916: atol 5e-3
    assert A.fused_attention_cuda.tensor_core_launches == before + 1
    step = 1 if form == "full" else shape[0]
    want = torch.cat([A.attention_reference(
        q[i: i + step], k[i: i + step], v[i: i + step], scale=80 ** -0.5,
        **{n: t[i: i + step] for n, t in kw.items()}) for i in range(0, shape[0], step)])
    if form == "windows":
        pv = torch.cat([A.attention_reference(
            q[i: i + step], k[i: i + step], v[i: i + step].abs(), scale=80 ** -0.5,
            **{n: t[i: i + step] for n, t in kw.items()}) for i in range(0, shape[0], step)])
        excess = (got.float() - want.float()).abs() - 2 ** -7 * want.float().abs() \
            - 2 ** -8 * pv.float()
        assert float(excess.max()) <= 0, float(excess.max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=5e-3)
    assert torch.equal(A.fused_attention_cuda(q, k, v, scale=80 ** -0.5, **kw), got)


def test_colqwen25_tower_on_card_launches_k2_at_both_forms(gen):
    """A 4-block qwen2_5 tower at ColQwen2.5's width (1,280, 16 heads of 80)
    on a ragged 10 x 14 grid (4 windows padded to 64 patches): window layers
    take K2 with ``kv_lens``, the full block with ``kv_valid``, all on the
    tensor cores; the bf16 output stays within 5% of its largest value of
    the same tower in float32 on the CPU."""
    import dataclasses

    from multimodal_colpali_tpu_torch.models.configs import ColQwen2ModelConfig
    from multimodal_colpali_tpu_torch.models.qwen2vl import Qwen2VisionTower
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_

    v = dataclasses.replace(ColQwen2ModelConfig.colqwen2_5_v0_2().vision, depth=4,
                            fullatt_block_indexes=(3,))
    cpu = Qwen2VisionTower(v, device="cpu", dtype=torch.float32).eval()
    init_random_params_(cpu, seed=1, family="colqwen2")
    card = Qwen2VisionTower(v, device="cuda", dtype=torch.bfloat16).eval()
    card.load_state_dict({n: t.to(torch.bfloat16) for n, t in cpu.state_dict().items()})
    x = torch.randn(2, 140, v.patch_dim, generator=torch.Generator().manual_seed(2))
    from multimodal_colpali_tpu_torch.models import layers as L

    calls = []
    orig = L.fused_attention

    def spy(q, k, v_, kv_lens=None, kv_valid=None, **kw):
        calls.append((tuple(q.shape), kv_lens is not None, kv_valid is not None))
        return orig(q, k, v_, kv_lens, kv_valid, **kw)

    L.fused_attention = spy
    try:
        before = A.fused_attention_cuda.tensor_core_launches
        with torch.no_grad():
            got = card(x.cuda().to(torch.bfloat16), 10, 14)
    finally:
        L.fused_attention = orig
    assert A.fused_attention_cuda.tensor_core_launches == before + 4
    assert calls == [((2 * 4, 64, 16, 80), True, False)] * 3 + [((2, 256, 16, 80), False, True)]
    with torch.no_grad():
        want = cpu(x, 10, 14)
    assert got.shape == want.shape == (2, 35, v.hidden_size)
    torch.testing.assert_close(got.float().cpu(), want, rtol=0,
                               atol=5e-2 * float(want.abs().max()))


def test_attention_at_the_granite_tower_shape(gen):
    """K2 at ColGranite's SigLIP-So400m at 384 px, 729 patches, a batch of 8
    ``[8, 729, 16, 72]`` bf16: its tensor-core path against the plain
    version within 5e-3 (the outputs average 729 values), a repeat
    bit-identical."""
    q, k, v = (_randn(gen, 8, 729, 16, 72, dtype=torch.bfloat16) for _ in range(3))
    before = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(q, k, v, scale=72 ** -0.5)
    assert A.fused_attention_cuda.tensor_core_launches == before + 1
    want = A.attention_reference(q, k, v, scale=72 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=5e-3)
    assert torch.equal(A.fused_attention_cuda(q, k, v, scale=72 ** -0.5), got)


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (9, 37, 21), (16, 576, 192), (300, 2048, 1024),
                                   (40, 3420, 1280), (2060, 1152, 136)])
def test_w8a8_dense_on_card_equals_the_exact_cpu_product(gen, m, k, n):
    """``torch._int_mm`` with its shape rules met by zero padding (rows to
    32, K and N to multiples of 8): the int32 sums equal an exact int64
    product on the host, and ``w8a8_dense`` (codes, sums, float32 epilogue)
    the CPU's bit for bit."""
    from multimodal_colpali_tpu_torch.ops import quant as Q

    x = _randn(gen, m, k, dtype=torch.bfloat16)
    w = _randn(gen, n, k, dtype=torch.bfloat16) * 0.05
    b = _randn(gen, n, dtype=torch.bfloat16)
    q = Q.quantize_int8(w, axis=1)
    xq, _ = Q.quantize_act_int8(x)
    acc = Q.int8_mm(xq, q["q8"])
    want = xq.cpu().long() @ q["q8"].cpu().long().T
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu().long(), want)
    got = Q.w8a8_dense(x, q["q8"], q["scale"], b)
    cpu = Q.w8a8_dense(x.cpu(), q["q8"].cpu(), q["scale"].cpu(), b.cpu())
    assert got.dtype == torch.bfloat16 and torch.equal(got.cpu(), cpu)


def _card_tower_vs_float32(tower_cls_kw, cfg, pix_shape, gen):
    """(bf16 forward on the card, float32 forward on the CPU) of one tower."""
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_
    from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower

    cpu = SiglipVisionTower(cfg, device="cpu", dtype=torch.float32, **tower_cls_kw).eval()
    init_random_params_(cpu, seed=1, family="siglip")
    card = SiglipVisionTower(cfg, device="cuda", dtype=torch.bfloat16, **tower_cls_kw).eval()
    card.load_state_dict({n: t.to(torch.bfloat16) for n, t in cpu.state_dict().items()})
    pix = torch.randn(pix_shape, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = card(pix.cuda().to(torch.bfloat16))
        want = cpu(pix)
    return got, want


def test_colsmol_split_tower_on_card_takes_k5a(gen):
    """ColSmol's SigLIP-768 at full width over a page's 4 tiles and global
    view (image splitting at 1,024 px): every layer on K5a (4 wgmma GEMMs a
    launch), the patches within 5e-2 of their scale of the float32 tower."""
    from multimodal_colpali_tpu_torch.models.configs import ColIdefics3ModelConfig
    from multimodal_colpali_tpu_torch.models.idefics3 import idefics3_position_index
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    cfg = ColIdefics3ModelConfig.colsmol_256m().vision
    before = (FL.fused_vit_layer_cuda.launches, FL.fused_gemm_cuda.wgmma_launches)
    got, want = _card_tower_vs_float32(dict(pos_index=idefics3_position_index(32)), cfg,
                                       (5, 512, 512, 3), gen)
    assert FL.fused_vit_layer_cuda.launches == before[0] + 12
    assert FL.fused_gemm_cuda.wgmma_launches == before[1] + 48
    assert got.shape == want.shape == (5, 1024, 768)
    torch.testing.assert_close(got.float().cpu(), want, rtol=0,
                               atol=5e-2 * float(want.abs().max()))


def test_granite_tower_on_card_runs_k2(gen):
    """ColGranite's feature tower (SigLIP-So400m at 384 px, cut to 4 blocks
    here, no post-LayerNorm) at full width: one K2 tensor-core launch a
    block at ``[3, 729, 16, 72]``, no fused layer, the patches within 5e-2
    of their scale of the float32 tower on the CPU."""
    import dataclasses

    from multimodal_colpali_tpu_torch.models.configs import ColGraniteModelConfig
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    cfg = dataclasses.replace(ColGraniteModelConfig.granite_vision_3().vision,
                              num_hidden_layers=4)
    before = (A.fused_attention_cuda.tensor_core_launches, FL.fused_vit_layer_cuda.launches)
    got, want = _card_tower_vs_float32(dict(post_layernorm=False), cfg, (3, 384, 384, 3), gen)
    assert A.fused_attention_cuda.tensor_core_launches == before[0] + 4
    assert FL.fused_vit_layer_cuda.launches == before[1]
    assert got.shape == want.shape == (3, 729, 1152)
    torch.testing.assert_close(got.float().cpu(), want, rtol=0,
                               atol=5e-2 * float(want.abs().max()))


# -- the old-model tier: Qwen2-VL-2B, LLaVA-NeXT-Llama3-8B, speculative verify ------------

@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(12, 2), (32, 8)])   # group 6 (Qwen2-VL-2B), 4 (Llama-3-8B)
def test_paged_attention_at_the_verify_shape(gen, kv, hq, hkv):
    """K7a / K7b over a speculative verify window: 4 slots x k = 4 queries
    ``[16, Hq, 128]``, each slot's block table repeated k times and row i of
    a slot attending ``length + i + 1`` rows (an inactive slot its length);
    the tensor-core path, against the plain version."""
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    b, k, d, page, nb = 4, 4, 128, 16, 384
    PA_, _, kp, vp, bt, _ = _paged_case(gen, b, hq, hkv, d, page, nb, torch.bfloat16)
    length = torch.tensor([900, 0, 4077, 2311], device="cuda")
    active = length > 0
    lens = torch.where(active[:, None], length[:, None] + torch.arange(k, device="cuda") + 1,
                       length[:, None]).reshape(-1).to(torch.int32)
    btf = bt.repeat_interleave(k, dim=0)
    q = _randn(gen, b * k, hq, d, dtype=torch.bfloat16)
    if kv == "int8":
        kc, ks = PA.quantize_kv_rows(kp)
        vc, vs = PA.quantize_kv_rows(vp)
        fn, args = PA.paged_attention_int8_cuda, (kc, ks, vc, vs)
        want = PA.paged_attention_int8_reference(q, *args, btf, lens, scale=d ** -0.5)
        atol = 0.035
    else:
        fn, args = PA.paged_attention_cuda, (kp, vp)
        want = PA.paged_attention_reference(q, *args, btf, lens, scale=d ** -0.5)
        atol = 2e-2
    before = fn.tensor_core_launches
    got = fn(q, *args, btf, lens, scale=d ** -0.5)
    assert fn.tensor_core_launches == before + 1
    assert float((got.float() - want.float()).abs().max()) < atol


@pytest.mark.parametrize("s,h,d", [(577, 16, 64), (2916, 16, 80)])   # CLIP-L/336; Qwen2-VL
def test_attention_at_the_old_model_tower_shapes(gen, s, h, d):
    """K2 at LLaVA-NeXT's CLIP tower (577 keys, D 64, with its CLS row) and
    Qwen2-VL's (2,916 patches, D 80), a batch of 5 images: the tensor-core
    path within 5e-3 of the plain version (one image at a time), a repeat
    bit-identical."""
    q, k, v = (_randn(gen, 5, s, h, d, dtype=torch.bfloat16) for _ in range(3))
    before = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(q, k, v, scale=d ** -0.5)
    assert A.fused_attention_cuda.tensor_core_launches == before + 1
    want = torch.cat([A.attention_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                            scale=d ** -0.5) for i in range(5)])
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=5e-3)
    assert torch.equal(A.fused_attention_cuda(q, k, v, scale=d ** -0.5), got)


@pytest.mark.parametrize("m", [4, 16, 40])
def test_int8_matmul_on_the_untied_llama_head(gen, m):
    """K8a on Llama-3-8B's untied head ``[M, 4096] -> 128,320`` (decode, a
    verify window, a prefill's rows), float32 out as the engine asks, within
    2% of the largest value of the plain version."""
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import quant as Q

    w = _randn(gen, 4096, 128320, dtype=torch.bfloat16) * 0.02
    head = Q.quantize_int8(w, axis=0)
    del w
    x = _randn(gen, m, 4096, dtype=torch.bfloat16)
    before = IM.int8_matmul_kn_cuda.launches
    got = IM.int8_matmul_kn(x, head["q8"], head["scale"], out_dtype=torch.float32)
    assert IM.int8_matmul_kn_cuda.launches == before + 1 and got.dtype == torch.float32
    want = IM.int8_matmul_reference(x.float(), head["q8"], head["scale"])
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())


def test_speculative_paged_batcher_on_card_takes_k7_at_the_verify_rows(gen):
    """A tiny Qwen2-VL in float32 on the card through the speculative paged
    batcher with an image request: K7a runs over ``B * spec_k`` verify rows
    every step, and the stream equals the engine's ``generate``."""
    import numpy as np
    import warnings

    from multimodal_colpali_tpu_torch.generation.engine import Qwen2DecodeEngine
    from multimodal_colpali_tpu_torch.generation.qwen2vl_mm import (
        Qwen2VLImagePreprocessor, Qwen2VLMMEngine)
    from multimodal_colpali_tpu_torch.generation.speculative import (
        SpeculativePagedContinuousBatcher)
    from multimodal_colpali_tpu_torch.models import registry as R
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg, params, _ = R.load_qwen2vl_mm("tiny-qwen2vl", device="cuda", dtype=torch.float32)
    lm = Qwen2DecodeEngine(cfg.text, params, dtype=torch.float32, device="cuda")
    mm = Qwen2VLMMEngine(cfg, params["visual"], lm)
    pix = Qwen2VLImagePreprocessor(cfg, device="cuda")([np.full((60, 40, 3), 77, np.uint8)])
    prompt = mm.build_mm_prompt([5, 9, 11, 5, 9, 11])
    want = mm.generate([prompt], pix[None], max_new_tokens=12)[0]
    calls = []
    orig = PA.paged_attention_cuda

    def seen(q, *a, **kw):
        calls.append(q.shape[0])
        return orig(q, *a, **kw)

    import multimodal_colpali_tpu_torch.generation.speculative as S
    S.paged_attention = seen
    try:
        bat = SpeculativePagedContinuousBatcher(lm, batch_slots=2, max_seq_len=64, chunk=2,
                                                page_size=8, mm_engine=mm, spec_k=4)
        fut = bat.submit(prompt, max_new_tokens=12, pixel_values=pix[0])
        bat.drain()
    finally:
        S.paged_attention = orig
    assert calls and set(calls) == {2 * 4}
    assert fut.result(30) == want


@pytest.mark.parametrize("rows,block", [(6432, 512), (4, 4)])
def test_mllama_blocked_attention_tensor_cores_equal_the_float32_einsum(gen, rows, block):
    """bf16 operands on the card take ``torch.bmm(..., out_dtype=float32)``:
    the einsum's exact products and float32 sums in another order, so each
    output is within a bf16 step of ``layers.attention``'s float32 einsum
    (the tower's shape, and a folded cross-attention decode over 1,601 rows)."""
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.models.mllama import blocked_masked_attention

    t = 6432 if rows > 4 else 1601
    q = _randn(gen, 1, rows, 16, 80, dtype=torch.bfloat16)
    k, v = (_randn(gen, 1, t, 16, 80, dtype=torch.bfloat16) for _ in range(2))
    mask = torch.rand((1, 1, rows, t), generator=gen, device="cuda") < 0.9
    got = blocked_masked_attention(q, k, v, mask, scale=80 ** -0.5, block=block).float()
    want = L.attention(q, k, v, mask=mask, scale=80 ** -0.5).float()
    assert float((got - want).abs().sub(2.0 ** -7 * want.abs()).max()) <= 1e-3


def _mllama_layer(device, dtype, seed=0):
    """A full-width gated Mllama tower layer (ViT-H/14: 1,280 wide, 16 heads
    of 80, MLP 5,120), N(0, fan_in^-0.5) weights from ``seed``."""
    from multimodal_colpali_tpu_torch.models.mllama import MllamaMMConfig, MllamaVisionLayer
    from multimodal_colpali_tpu_torch.models.registry import init_random_params_

    cfg = MllamaMMConfig.llama32_11b_vision().vision
    layer = MllamaVisionLayer(cfg, True, device="cpu", dtype=torch.float32)
    init_random_params_(layer, seed, family="mllama")
    with torch.no_grad():
        layer.gate_attn.fill_(0.25)
        layer.gate_ffn.fill_(0.25)
    return cfg, layer.to(device, dtype).eval()


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_mllama_tower_layer_at_full_width_matches_the_cpu(gen, dtype, rel):
    """One gated tower layer over an image's 4 tile slots (6,432 tokens, one
    real tile) with HF's invalid-invalid mask: the card (its query-blocked
    attention, past 2,048 tokens) against the CPU in float32, relative L2."""
    cfg, cpu = _mllama_layer("cpu", torch.float32)
    _, card = _mllama_layer("cuda", dtype)
    t, pp, p = cfg.max_num_tiles, cfg.num_patches_padded, cfg.num_patches
    x = torch.randn((1, t * pp, cfg.hidden_size), generator=torch.Generator().manual_seed(1))
    valid = (torch.arange(t)[:, None] < 1) & (torch.arange(pp)[None] < p)
    inv = ~valid.reshape(1, -1)
    mask = ~(inv[:, :, None] & inv[:, None, :])[:, None]
    with torch.inference_mode():
        want = cpu(x, mask)
        got = card(x.to("cuda", dtype), mask.cuda()).float().cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).norm() / want.norm()) <= rel


def test_mllama_cross_block_at_full_width_matches_the_cpu(gen):
    """One gated cross-attention block at Llama-3.2-11B-Vision's width (32
    query heads over 8 KV heads of 128, MLP 14,336) on 4 verify rows over an
    image's 1,601 pooled rows plus masked padding: bf16 on the card against
    float32 on the CPU from the same bf16 weights, relative L2 within 2e-2."""
    import types

    from multimodal_colpali_tpu_torch.generation.mllama_mm import MllamaMMEngine
    from multimodal_colpali_tpu_torch.models.mllama import MllamaMMConfig

    cfg = MllamaMMConfig.llama32_11b_vision()
    c = cfg.text
    g = torch.Generator().manual_seed(2)
    h, hd, inter = c.hidden_size, c.head_dim, c.intermediate_size

    def mat(i, o):
        return (torch.randn((i, o), generator=g) * i ** -0.5).to(torch.bfloat16)

    ones = lambda n: torch.ones(n, dtype=torch.bfloat16)  # noqa: E731
    lp = {"cross_attn": {"q_proj": {"kernel": mat(h, 32 * hd)}, "o_proj": {"kernel": mat(32 * hd, h)},
                         "q_norm": {"weight": ones(hd)}},
          "input_layernorm": {"weight": ones(h)}, "post_attention_layernorm": {"weight": ones(h)},
          "mlp": {"gate_proj": {"kernel": mat(h, inter)}, "up_proj": {"kernel": mat(h, inter)},
                  "down_proj": {"kernel": mat(inter, h)}},
          "gate_attn": torch.full((1,), 0.25, dtype=torch.bfloat16),
          "gate_mlp": torch.full((1,), 0.25, dtype=torch.bfloat16)}
    rows = 2 * cfg.vision.num_patches
    ck, cv = (torch.randn((1, rows, c.num_key_value_heads, hd), generator=g).to(torch.bfloat16)
              for _ in range(2))
    x = torch.randn((1, 4, h), generator=g).to(torch.bfloat16)
    mask = (torch.arange(rows) < cfg.vision.num_patches)[None, None, None, :]
    eng = types.SimpleNamespace(cfg=cfg)

    def tree(t, dev, dt):
        return ({k: tree(v, dev, dt) for k, v in t.items()} if isinstance(t, dict)
                else t.to(dev, dt))

    with torch.inference_mode():
        want = MllamaMMEngine._cross_block(eng, tree(lp, "cpu", torch.float32), x.float(),
                                           ck.float(), cv.float(), mask, None)
        got = MllamaMMEngine._cross_block(eng, tree(lp, "cuda", torch.bfloat16), x.cuda(),
                                          ck.cuda(), cv.cuda(), mask.cuda(), None)
    got = got.float().cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).norm() / (want - x.float()).norm()) <= 2e-2


# -- K2's backward (training) -----------------------------------------------------

def _bwd_case(gen, b, s, h, d, masks):
    q, k, v, g = (_randn(gen, b, s, h, d) for _ in range(4))
    kw = _attention_masks(gen, b, s, masks)
    out = A.attention_reference(q, k, v, scale=d ** -0.5, **kw)
    return q, k, v, out, g, kw


def _assert_grads_close(got, want, rel=1e-4):
    """Each of dq, dk, dv within ``rel`` of its largest element: float32
    sums over up to 1,031 keys or queries in another order than the plain
    version's einsums (relative errors of ~1e-6 seen on the CPU)."""
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        assert torch.isfinite(a).all(), name
        err = float((a - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-7, (name, err, float(w.abs().max()))


@pytest.mark.parametrize("d", [8, 20, 72, 128])
@pytest.mark.parametrize("s", [40, 1031])
@pytest.mark.parametrize("masks", ["none", "kv_lens", "kv_valid", "causal", "all"])
def test_attention_backward_kernel_matches_plain(gen, d, s, masks):
    """K2's backward against ``attention_backward_reference``: D = 8, 20 (not
    a multiple of 8), 72 (So400m's), 128; ragged tiles; each mask and all
    three, the last batch row's keys all masked under kv_valid."""
    b, h = 2, 3
    q, k, v, out, g, kw = _bwd_case(gen, b, s, h, d, masks)
    before = A.fused_attention_backward_cuda.launches
    got = A.fused_attention_backward_cuda(q, k, v, out, g, scale=d ** -0.5, **kw)
    assert A.fused_attention_backward_cuda.launches == before + 1
    want = A.attention_backward_reference(q, k, v, out, g, scale=d ** -0.5, **kw)
    _assert_grads_close(got, want)
    if "kv_valid" in kw:  # a fully masked row: uniform P, gradient to dv only
        assert not got[0][-1].any() and not got[1][-1].any()
        torch.testing.assert_close(got[2][-1], g[-1].sum(0, keepdim=True).expand(s, h, d) / s,
                                   rtol=1e-5, atol=1e-6)


def test_attention_backward_at_the_training_shape(gen):
    """At the training path's ``[3, 1024, 16, 72]`` (ColPali's So400m over
    chip_smoke's 3 pages), no mask: against the plain version, and a repeat
    bit-identical (no atomics)."""
    q, k, v, out, g, _ = _bwd_case(gen, 3, 1024, 16, 72, "none")
    got = A.fused_attention_backward_cuda(q, k, v, out, g, scale=72 ** -0.5)
    _assert_grads_close(got, A.attention_backward_reference(q, k, v, out, g, scale=72 ** -0.5))
    again = A.fused_attention_backward_cuda(q, k, v, out, g, scale=72 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_attention_function_runs_both_kernels(gen):
    """Under grad, float32 q, k, v that require grad go through the autograd
    Function: one K2 forward launch on its 3xTF32 path, one backward launch,
    and the gradients are the backward kernel's."""
    q, k, v, _, g, kw = _bwd_case(gen, 2, 150, 3, 72, "all")
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = A.fused_attention_cuda, A.fused_attention_backward_cuda
    before = (fwd.launches, fwd.tf32_launches, bwd.launches)
    out = A.fused_attention(*xs, scale=0.1, **kw)
    assert (fwd.launches, fwd.tf32_launches) == (before[0] + 1, before[1] + 1)
    out.backward(g)
    assert bwd.launches == before[2] + 1
    want = A.fused_attention_backward_cuda(q, k, v, out.detach(), g, scale=0.1, **kw)
    assert all(torch.equal(x.grad, w) for x, w in zip(xs, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_attention_is_unchanged_by_the_function(gen, dtype):
    """The Function is entered only under grad: an inference call is the
    same launch with no graph, and the Function's forward output is that
    launch's bit for bit (float32; bf16 has no gradient)."""
    q, k, v = (_randn(gen, 2, 1024, 16, 72, dtype=dtype) for _ in range(3))
    direct = A.fused_attention_cuda(q, k, v, scale=72 ** -0.5)
    plain = A.fused_attention(q, k, v, scale=72 ** -0.5)
    assert plain.grad_fn is None and torch.equal(plain, direct)
    with torch.no_grad():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        assert torch.equal(A.fused_attention(*xs, scale=72 ** -0.5), direct)
    if dtype == torch.float32:
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = A.fused_attention(*xs, scale=72 ** -0.5)
        assert out.grad_fn is not None and torch.equal(out.detach(), direct)


def test_fused_attention_refuses_bf16_under_grad(gen):
    x = _randn(gen, 1, 64, 2, 72, dtype=torch.bfloat16).requires_grad_()
    before = A.fused_attention_cuda.launches
    with pytest.raises(NotImplementedError, match="bfloat16"):
        A.fused_attention(x, x, x, scale=0.1)
    assert A.fused_attention_cuda.launches == before


def _card_no_backward_calls():
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA
    from multimodal_colpali_tpu_torch.ops import quant as Q
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    dev = "cuda"
    bf = torch.bfloat16

    def g(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev).to(dtype).requires_grad_()

    w, b = torch.zeros(64, 64, dtype=bf, device=dev), torch.zeros(64, device=dev)
    pool = torch.zeros(3, 16, 1, 64, device=dev)
    pool8 = torch.zeros(3, 16, 1, 64, dtype=torch.int8, device=dev)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    return {
        "attention": (A.fused_attention_cuda,
                      lambda: A.fused_attention_cuda(*(g(1, 64, 2, 72),) * 3, scale=0.1)),
        "attention_backward": (A.fused_attention_backward_cuda,
                               lambda: A.fused_attention_backward_cuda(
                                   *(g(1, 64, 2, 72),) * 5, scale=0.1)),
        "maxsim": (M.maxsim_scores_cuda,
                   lambda: M.maxsim_scores_cuda(g(1, 4, 128), torch.zeros(3, 8, 128, device=dev))),
        "maxsim_int8": (M.maxsim_scores_int8_cuda, lambda: M.maxsim_scores_int8_cuda(
            g(1, 4, 128), torch.zeros(3, 8, 128, dtype=torch.int8, device=dev),
            torch.ones(3, 8, device=dev))),
        "vit_layer": (FL.fused_vit_layer_cuda, lambda: FL.fused_vit_layer_cuda(
            g(1, 16, 64, dtype=bf), b, b, *(w, b) * 4, b, b, w, b, w, b, heads=2)),
        "attn_block": (FL.fused_vit_attention_block_cuda, lambda: FL.fused_vit_attention_block_cuda(
            torch.zeros(1, 16, 64, dtype=bf, device=dev), g(64), b, *(w, b) * 4, heads=2)),
        "mlp_block": (FL.fused_mlp_block_cuda, lambda: FL.fused_mlp_block_cuda(
            torch.zeros(1, 16, 64, dtype=bf, device=dev), b, b, g(64, 64, dtype=bf), b, w, b)),
        "fused_gemm": (FL.fused_gemm_cuda, lambda: FL.fused_gemm_cuda(
            g(64, 64, dtype=bf), (w,), (b,), "bias")),
        "ln_stats": (FL.ln_stats_cuda, lambda: FL.ln_stats_cuda(g(64, 64, dtype=bf), 1e-6)),
        "window_attention": (WA.window_attention_cuda, lambda: WA.window_attention_cuda(
            *(g(3, 144, 32, dtype=bf),) * 3, scale=0.1)),
        "paged_attention": (PA.paged_attention_cuda, lambda: PA.paged_attention_cuda(
            g(1, 2, 64), pool, pool, bt, lens, scale=0.1)),
        "paged_attention_int8": (PA.paged_attention_int8_cuda, lambda: PA.paged_attention_int8_cuda(
            g(1, 2, 64), pool8, torch.ones(3, 16, 1, device=dev), pool8,
            torch.ones(3, 16, 1, device=dev), bt, lens, scale=0.1)),
        "int8_matmul_kn": (IM.int8_matmul_kn_cuda, lambda: IM.int8_matmul_kn_cuda(
            g(8, 64, dtype=bf), torch.zeros(64, 32, dtype=torch.int8, device=dev),
            torch.ones(32, device=dev))),
        "int8_matmul_nk": (IM.int8_matmul_nk_cuda, lambda: IM.int8_matmul_nk_cuda(
            g(8, 64, dtype=bf), torch.zeros(32, 64, dtype=torch.int8, device=dev),
            torch.ones(32, device=dev))),
        "int4_matmul_kn": (I4.int4_matmul_kn_cuda, lambda: I4.int4_matmul_kn_cuda(
            g(8, 64, dtype=bf), torch.zeros(32, 32, dtype=torch.uint8, device=dev),
            torch.ones(1, 32, device=dev))),
        "w8a8_dense": (None, lambda: Q.w8a8_dense(
            g(4, 64), torch.zeros(32, 64, dtype=torch.int8, device=dev),
            torch.ones(32, device=dev))),
    }


_NO_BACKWARD = ["attention", "attention_backward", "maxsim", "maxsim_int8", "vit_layer",
                "attn_block", "mlp_block", "fused_gemm", "ln_stats", "window_attention",
                "paged_attention", "paged_attention_int8", "int8_matmul_kn", "int8_matmul_nk",
                "int4_matmul_kn", "w8a8_dense"]


@pytest.mark.parametrize("name", _NO_BACKWARD)
def test_kernels_without_backward_refuse_grad_on_card(gen, name):
    """No wrapper hands back a tensor without a gradient while grad is on
    and an input requires it: each raises and launches nothing (K2's own
    wrappers too: ``fused_attention`` carries their gradient)."""
    wrapper, call = _card_no_backward_calls()[name]
    before = None if wrapper is None else wrapper.launches
    with pytest.raises(NotImplementedError, match="has no backward"):
        call()
    assert wrapper is None or wrapper.launches == before


def test_siglip_layer_gradient_on_card_matches_the_plain_step(gen):
    """One So400m encoder layer (width 1,152, 16 heads of 72) over 2 x 1,024
    patches in float32: the loss ``sum(layer(x) * w)`` and every gradient
    with K2 and its backward against ``set_fused_attention(False)`` (the
    einsum's autograd). The loss within 1e-6 of ``sum|layer(x) * w|``; each
    leaf within 1e-4 of its largest element plus 1e-6 of the largest
    gradient of the layer (the k-projection bias's true gradient is 0: both
    sides return rounding noise there)."""
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.models.configs import SiglipVisionConfig
    from multimodal_colpali_tpu_torch.models.siglip import SiglipEncoderLayer

    cfg = SiglipVisionConfig()
    layer = SiglipEncoderLayer(cfg, device="cuda", dtype=torch.float32)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * p.shape[-1] ** -0.5
                    if p.dim() > 1 else torch.ones_like(p))
    L.set_trainable(layer)
    x = _randn(gen, 2, 1024, cfg.hidden_size)
    w = _randn(gen, 2, 1024, cfg.hidden_size)
    grads, losses = [], []
    for fused in (None, False):
        L.set_fused_attention(fused)
        try:
            before = A.fused_attention_backward_cuda.launches
            layer.zero_grad(set_to_none=True)
            terms = layer(x) * w
            loss = terms.sum()
            loss.backward()
            assert A.fused_attention_backward_cuda.launches == before + (fused is None)
        finally:
            L.set_fused_attention(None)
        losses.append((float(loss), float(terms.detach().abs().sum())))
        grads.append({n: p.grad.clone() for n, p in layer.named_parameters()})
    assert abs(losses[0][0] - losses[1][0]) <= 1e-6 * losses[1][1]
    top = max(float(g.abs().max()) for g in grads[1].values())
    for n, want in grads[1].items():
        err = float((grads[0][n] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6 * top, (n, err)
