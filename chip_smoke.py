#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``. It
drives ``multimodal_colpali_tpu_torch`` (never JAX) and prints one line per
phase; any failure exits non-zero.

1. Device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the build time of the kernels (nvcc for K1/K4, K2, K3, the
   K5 GEMM, K6, K7a/K7b, K8a/K8b and K9 into ``build/kernels``, all at once).
2. Kernels against their plain PyTorch versions, both on the card, at the
   main paths' shapes, with the time of each beside its bound (the larger of
   the bytes it must move over 3.35 TB/s and its operations over the peak
   rate of their type): K1 MaxSim and K4 int8 MaxSim (4 queries of 32
   tokens over 4,096 pages of up to 1,030, on their tensor-core path; also
   the store's one query, and for K1 a sweep's 120 queries, checked bit for
   bit against 120 calls of one and against the plain version on 128 pages;
   a repeated call, an odd page count and a query alone bit-identical; K1's
   CUDA-core kernel on float32 pages), K2 attention (and
   ``scaled_dot_product_attention`` on the same inputs), K3 normalize (as
   graph replays cycling over 12 input sets, the eager time beside; every
   byte value in each channel position under two statistics, a repeat
   bit-identical), K5a-c
   fused SigLIP layer / attention block / MLP block (as CUDA-graph replays,
   each of its bf16 GEMMs on ``gemm_wgmma``), the four GEMMs they are made
   of alone at M = 8,192 (QKV with LN, out_proj + residual, fc1 with LN +
   gelu, fc2 + residual: per element within 2^-7|want| + 2e-3 of
   ``gemm_reference``, plus one bf16 step of the product through gelu or
   the residual;
   with a LayerNorm, on the kernel's own normalized A, which an identity
   weight gives exactly and which must be within a bf16 step of
   ``F.layer_norm``'s;
   bit-exact on grid inputs, a repeat bit-identical; cuBLAS's bare product
   on the normalized input beside each, timed only) and the LayerNorm
   statistics pre-pass, and at gemma-3-27b's
   shapes K7a paged attention and K7b over int8 pools (window 0 and 1024, at
   phase 2's 8 slots of up to 4,096 tokens and at the paged batcher's decode
   step, 4 slots at 309-1,509 tokens; bf16 on K7's tensor-core path, float32
   on its CUDA-core path; repeat bit-identical), K8a
   int8 projections and K9 group-wise int4 projections (decode rows of 8
   tokens, prefill rows of 512 and 1,504 tokens through the up and down
   projections; both exact on grid inputs, both bit-identical on a repeated
   call), K8b the int8 tied LM head; K6 window attention at ColFlor's four
   DaViT stage shapes in bf16 on its ring kernel (graph replays, a repeat
   bit-identical, ``scaled_dot_product_attention`` on the same inputs) and at
   stage 0 in float32. K2 must take its tensor-core path for bf16 with D % 8 == 0
   and its CUDA-core path otherwise, K8a and K9 their decode tile for M <= 16
   and their prefill tile above. K1, K4, K7, K8 and K9 (K7-K9's decode calls
   are shorter than their Python launch) are timed as CUDA-graph replays (their eager
   per-call time printed beside), with ``torch._weight_int8pack_mm`` and
   ``torch._weight_int4pack_mm`` on the same inputs as yardsticks where this
   torch has a CUDA kernel for them, and beside the prefill rows one bf16
   ``torch.mm`` on the weight already dequantized (the cuBLAS time the
   prefill tiles race against). Then, at the shapes phase 7 gives them
   (PaliGemma's Gemma-2B: 8 query heads over 1 KV head of 256, hidden
   2,048, MLP 16,384, vocab 257,216), K7a over 4 slots of 6,144 tokens at a
   1-page and a 5-page image prompt's lengths and two text prompts', K8a on
   every decode projection and on the MLP at both image prompts' prefill
   rows, and K8b on the head, each against its plain version at the limits
   above; K8a's prefill tile on gemma-3-27b's attention and MLP projections
   at the rows of phase 8's image prompts and of its second question's tail.
   Last, K2 at the shape phase 8 gives it, Gemma-3's SigLIP-So400m at 896 px:
   5 images of 4,096 patches ``[5, 4096, 16, 72]`` (the plain version one
   image at a time, SDPA beside) at atol 5e-3, which the outputs' smaller
   scale at 4,096 keys calls for.
3. ColPali at full width, from a checkpoint: a bf16 HF-layout checkpoint of
   ``vidore/colpali-v1.3`` (the ``ColPaliForRetrieval`` tensors, 5.85 GB,
   norms at their identity, every other tensor N(0, fan_in^-0.5) from
   ``--seed``) is written under ``build/`` as 3 safetensors files by the
   script's own writer, after a check of the free disk space, and loaded
   with ``load_retriever(checkpoint_dir=)``: the load time and rate, the
   host's peak RSS growth and the device memory are printed, and 11
   parameters across the tower, projector, LM and head must equal the file's
   tensors after the converter's transposes. The model then embeds 16
   synthetic 448x448 pages, indexes them with ``colpali_qdrant``, answers 4
   queries with ``retrieve_colpali`` (one also under a ``username`` filter)
   and scores them with ``score_results``; ``prompt_prep_query(type=
   "colpali")`` on the first query must build one image prompt for each page
   ``retrieve_colpali`` finds, the pages' files in its order.
4. ColSmol at full width: ``vidore/colSmol-256M`` (random bf16 weights)
   embeds 32 synthetic 512x512 pages, indexes them with ``colpali_qdrant``
   into an exact, an int8, a pooled and an on_disk collection (the last
   saved and reopened), and answers 4 queries with ``query_points`` in each;
   it also embeds one batch through each partial fused kernel. Every bf16
   GEMM of the tower must take ``gemm_wgmma``: 4 a K5a launch (12 x 4 a
   batch), 2 a K5b or K5c, none on the CUDA cores.
5. Generation at full width: ``google/gemma-3-27b-it`` (62 layers, random
   weights from ``--seed``) behind ``PagedContinuousBatcher`` (4 slots of
   2048 tokens, pages of 16) and ``GenerationServer`` on 127.0.0.1 answers 6
   concurrent OpenAI chat requests over HTTP (synthetic RAG-style MCQ prompts
   of 300-1,600 tokens: greedy, one streamed, one with the MCQ
   ``response_format``, two sampled with one seed), in three runs: (a) bf16
   weights and pools (K7a), (b) int8 pools (K7b), (c) int8 weights made leaf
   by leaf (K8a, K8b). Each greedy reply must equal the engine's own
   ``generate`` or first differ where the engine's top two logits are within
   0.05; the two sampled replies must agree; the MCQ reply must be a choice.
   Run (d) serves the greedy requests again from int4 weights made leaf by
   leaf (K9 on every projection; K8b on the head, whose table stays int8).
6. ColFlor at full width: ``ahmed-masry/ColFlor`` (random bf16 weights)
   embeds 16 synthetic 768x768 pages, indexes them with ``colpali_qdrant``,
   answers 4 queries with ``retrieve_colpali`` (one also filtered) and scores
   them with ``score_results``; its DaViT windows run K6's ring kernel (12
   launches a forward), never K2.

7. Image-context serving at full width, right after phase 3, on its
   checkpoint's weights (reloaded; the directory is deleted after this
   phase): ``PaliGemmaEngine`` runs the retriever's own SigLIP tower and
   projector and decodes through the text engine's LM.
   ``PagedContinuousBatcher`` (4 slots of 6,144 tokens, pages of 16) serves
   two greedy image requests, one page and the 5 pages phase 3 retrieved for
   its first query, beside two text requests, all submitted at once; then
   an MCQ is scored over the 5 pages through ``next_token_logits``. Run (a)
   has bf16 LM weights, run (b) int8 weights (K8a, K8b). Each greedy reply
   must equal the isolated engine's (``PaliGemmaEngine.generate`` or
   ``GemmaDecodeEngine.generate``) or first differ where that engine's top
   two logits are within 0.05 (the gaps the engine records as it decodes,
   ``record_top2``). TTFT of each request, decode tokens/s, the
   MCQ's time and the peak memory are printed with the card, and the 5-page
   prefill split by CUDA events into tower, projector and LM.
8. The reference's whole generator, right after phase 5:
   ``google/gemma-3-27b-it`` with images at full width and depth (random
   weights from ``--seed`` through ``load_gemma3_mm``; SigLIP-So400m at
   896 px, 256 soft tokens an image): the text engine and a
   ``Gemma3MMEngine`` on its LM in ``PagedContinuousBatcher`` (4 slots of
   2,048 tokens, pages of 16, prefix caching) serve a 1-image request, a
   5-image one (exp-02's top 5, synthetic 896 x 896 pages), a second
   question over the same 5 images, which must prefill only its tail
   against the shared image pages (counted among the image requests' own
   prefills), and two text requests, all submitted at
   once; then an MCQ over the 5 images through ``next_token_logits``. Run
   (a) has bf16 LM weights, run (b) int8 made leaf by leaf (K8a, K8b). The
   gates and the printout are phase 7's.

9. The dense RAG modes at full width, bf16: ``BAAI/bge-base-en-v1.5``
   (BERT-base, ``BertConfig.bge_base()``). (a) A bf16 HF ``BertModel``
   checkpoint of random values from ``--seed`` is written under ``build/``
   and loaded through ``BgeEmbeddings(checkpoint_dir=)``: no random-init
   warning, 8 leaves equal to the file's. (b) ``api.qdrant_process``
   indexes 4,096 synthetic chunks of 64-512 tokens with langchain payloads
   (every 8th a figure summary with an ``img_link``); its one
   ``embed_documents`` pass (batches of 64) is timed (chunks/s and unpadded
   tokens/s printed): unit norms within 1e-3, and on 64 chunks a cosine >=
   0.995 with a float32 forward of the same weights. (c) 95,904 synthetic
   unit vectors fill the collection to 100,000 chunks over 4 users. (d) 120
   questions, each through ``embed_query``, a search without a filter,
   ``TpuVectorStore.similarity_search_with_score(k=5)`` under the user's
   filter and ``prompt_prep_query(type="mm_RAG")`` (and ``type=""`` once):
   ms a query split into embed, search without and with the filter; the
   top-5 equal to a float32 product of the same bf16 corpus with a stable
   sort up to near-ties (gap < 1e-5), the filter keeping to the user, 16
   chunks first by their own text within 5e-2 of 1. (e)
   ``VectorClient(path).save()`` and a new ``VectorClient(path)``: 5 queries
   give the same ids and scores bit for bit. No kernel counter may rise in
   (b)-(e): BERT's attention has a key-padding mask (the plain einsum, as
   in JAX) and the search is one product and a sort.

Each main path (3, 4, each run of 5, 6, 7, 8 and 9) sets every launch
counter to 0 before it runs and reads them after; each kernel of the path
must have run in it (ColPali, ColSmol and ColFlor: K1's tensor-core path,
ColSmol K4's too; ColPali, ColSmol and both runs of 7: K2's tensor-core
path; every run of phases 5, 7 and 8: K7's tensor-core path; both runs of 8:
K2's tensor-core path; run (c) and image runs (b): both of K8a's tiles and
K8b; run (d): both of K9's tiles; phase 9: none, every counter stays 0). The line before the last is a JSON object with
each kernel's launches in those paths, its error against the plain version,
its time, the plain version's, its bound and, for K2, K6, K8a, K8b and K9,
the library call's (null where this torch has none); K8a and K9 have a row a
tile (``int8_matmul_kn`` / ``int4_matmul_kn`` the decode tile at 8 tokens,
``*.prefill`` the prefill tile at 512), K2 a second row at the Gemma-3
tower's shape (``attention.gemma3_tower``, phase 8's launches), the K5 GEMM a row a role
(``gemm.qkv``, ``gemm.out_proj``, ``gemm.fc1``, ``gemm.fc2``, each with
``cublas_bare_ms``) and its statistics pre-pass one (``ln_stats``). The last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import base64
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "multimodal_colpali_tpu_torch"

K1 = dict(b=4, nq=32, dim=128, p=4096, nt=1030)
K2 = dict(b=8, s=1024, h=16, d=72)
K2_GEMMA3 = dict(b=5, s=4096, h=16, d=72)   # Gemma-3's So400m at 896 px, 5 images
# N(0, 1) inputs at scale 72^-0.5 average 4,096 values: outputs of std about
# sqrt(e / 4096) = 0.026, so K2's 2e-2 (set at 1,024 keys) would pass a kernel
# that dropped a 64-key block (max|err| about 0.017); bf16 rounding of P and
# the output stays near 2e-3 here
K2_GEMMA3_ATOL = 5e-3
K3 = dict(b=8, size=448, sets=12)  # 12 x 4.8 MB of pixels: more than the 50 MB L2
K5 = dict(b=8, s=1024, h=768, heads=12, inter=3072)  # ColSmol's SigLIP layer
# gemma-3-27b: 32 q / 16 kv heads of 128, pages of 16, 8 slots of up to 4096 tokens
K7 = dict(b=8, hq=32, hkv=16, d=128, page=16, nb=256)
K8 = dict(h=5376, inter=21504, vocab=262208)   # gemma-3-27b, also K9's (group 256)
K6 = dict(n=8192, s=144, d=32)    # ColFlor stage 0 at batch 8: 8 x 256 windows x 4 heads
K6_STAGES = (8192, 4096, 2048, 1024)  # ColFlor's four DaViT stages at batch 8 (heads 4 ... 32)
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12   # H100 SXM peaks (data sheet)
N_PAGES, EMBED_BATCH, TOP_K = 16, 8, 5
SMOL_PAGES, SMOL_BATCH = 32, 16
QUERIES = [
    "what binds selectins",
    "glycan structures in biology",
    "binding affinity measurements",
    "supplementary data tables",
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed_pair(torch, kernel_fn, plain_fn, iters: int):
    """Per-call ms of the kernel and the plain version, CUDA events, taken
    in turns (plain, kernel, kernel, plain) after one warm-up call each."""
    def run(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain_fn), run(kernel_fn), run(kernel_fn), run(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row(err, ms, plain_ms, nbytes, flops, peak=BF16_FLOPS, library_ms=None):
    bound_ms, by = bound(nbytes, flops, peak)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=library_ms)


def library_op(torch, name: str):
    """``torch.<name>`` when this torch registers a CUDA kernel for
    ``aten::<name>``, else None (printed): a yardstick, timed only."""
    if torch._C._dispatch_has_kernel_for_dispatch_key(f"aten::{name}", "CUDA"):
        return getattr(torch, name)
    print(f"[kernels] aten::{name}: none on this torch (no CUDA kernel)", flush=True)
    return None


def bf16_ulps(torch, a, b):
    """Distance in bf16 units in the last place (same-sign values)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def ptxas_summary(libs) -> str:
    """Most registers and the number of instantiations that spill, per library."""
    parts = []
    for name, lib in sorted(libs.items()):
        log = lib.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = len([n for n in re.findall(r"(\d+) bytes spill stores", text) if int(n)])
        parts.append(f"{name} <= {max(regs, default=0)} regs, {spills}/{len(regs)} spill")
    return "; ".join(parts)


def phase_device(torch, build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    nvcc_s = time.perf_counter() - t0
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | build: nvcc "
          f"{nvcc_s:.1f} s ({', '.join(sorted(libs))}) | ptxas: {ptxas_summary(libs)}",
          flush=True)
    return card


def phase_kernels(torch, seed: int):
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    # K1: MaxSim at [4, 32, 128] x [4096, 1030, 128] bf16, ragged pages, some empty
    c = K1
    q32 = F.normalize(torch.randn(c["b"], c["nq"], c["dim"], generator=g, device=dev), dim=-1)
    q = q32.to(torch.bfloat16)
    d = torch.empty(c["p"], c["nt"], c["dim"], dtype=torch.bfloat16, device=dev)
    for s in range(0, c["p"], 512):
        part = torch.randn(min(512, c["p"] - s), c["nt"], c["dim"], generator=g, device=dev)
        d[s: s + 512] = F.normalize(part, dim=-1).to(torch.bfloat16)
    q_lens = torch.tensor([c["nq"], 20, 1, c["nq"]], dtype=torch.int32, device=dev)
    d_lens = torch.randint(1, c["nt"] + 1, (c["p"],), generator=g, device=dev, dtype=torch.int32)
    d_lens[::97] = 0
    tc = M.maxsim_scores_cuda.tensor_core_launches
    got = M.maxsim_scores_cuda(q, d, q_lens, d_lens)
    require(M.maxsim_scores_cuda.tensor_core_launches == tc + 1,
            "K1: bf16 with DIM % 16 == 0 did not take the tensor-core path")
    want = M.maxsim_scores_reference(q, d, q_lens, d_lens)
    torch.cuda.synchronize()
    live = d_lens > 0
    require(bool(torch.isfinite(got).all()), "K1: non-finite score")
    require(torch.allclose(got[:, live], want[:, live], rtol=1e-3, atol=1e-3),
            "K1: scores differ from the plain version beyond rtol 1e-3")
    empty_want = -q_lens.double()[:, None] * 1e30
    require(torch.allclose(got[:, ~live].double(), empty_want.expand(-1, int((~live).sum())),
                           rtol=1e-5), "K1: empty pages do not score -q_len * 1e30")
    k1_err = float((got[:, live] - want[:, live]).abs().max())
    kv, ki = topk_with_stable_ties(got, 5)
    pv, pi = topk_with_stable_ties(want, 5)
    gap = (want.gather(1, ki.long()) - pv).abs()
    require(bool((gap <= 1e-3 * pv.abs() + 1e-3).all()),
            "K1: top-5 differs from the plain version beyond ties")
    # bit for bit: a repeated call, an odd page count, a query alone
    odd = c["p"] - 3
    require(torch.equal(M.maxsim_scores_cuda(q, d, q_lens, d_lens), got),
            "K1: a repeated call differs")
    require(torch.equal(M.maxsim_scores_cuda(q, d[:odd], q_lens, d_lens[:odd]), got[:, :odd]),
            "K1: an odd page count differs")
    require(torch.equal(M.maxsim_scores_cuda(q[1:2], d, q_lens[1:2], d_lens), got[1:2]),
            "K1: a query alone (B = 1) differs from its row of the batch")
    k_ms, p_ms = timed_pair(torch, lambda: M.maxsim_scores_cuda(q, d, q_lens, d_lens),
                            lambda: M.maxsim_scores_reference(q, d, q_lens, d_lens), iters=5)
    g_ms = graph_ms(lambda: M.maxsim_scores_cuda(q, d, q_lens, d_lens), iters=20)
    live_d = float(d_lens.sum())   # the tokens this data needs

    def k1_bytes(qq, out):
        return live_d * c["dim"] * 2 + qq.numel() * 2 + out.numel() * 4

    results["maxsim"] = row(k1_err, g_ms, p_ms, k1_bytes(q, got),
                            2.0 * c["dim"] * float(q_lens.sum()) * live_d)
    top_same = bool((ki == pi).all())
    print(f"[kernels] K1 maxsim {list(q.shape)}x{list(d.shape)} bf16: max|err| {k1_err:.3g} "
          f"(rtol 1e-3), empty pages exact, top-5 {'identical' if top_same else 'equal up to ties'}"
          f", repeat / odd page count / B = 1 bit-identical | graph replay {g_ms:.4f} ms (eager "
          f"{k_ms:.4f}), plain {p_ms:.3f} ms, bound {results['maxsim']['bound_ms']:.4f} ms",
          flush=True)
    del want
    torch.cuda.empty_cache()

    # K1 at the store's one query (B = 1) and a sweep's 120 queries, same corpus
    g2 = torch.Generator(device=dev).manual_seed(seed + 1)
    q120 = F.normalize(torch.randn(120, c["nq"], c["dim"], generator=g2, device=dev),
                       dim=-1).to(torch.bfloat16)
    lens1, lens120 = q_lens[:1], torch.full((120,), c["nq"], dtype=torch.int32, device=dev)
    one = M.maxsim_scores_cuda(q[:1], d, lens1, d_lens)
    require(torch.equal(one, got[:1]), "K1: B = 1 differs from its row of the batch")
    b1_ms = graph_ms(lambda: M.maxsim_scores_cuda(q[:1], d, lens1, d_lens), iters=20)
    b1_bound, _ = bound(k1_bytes(q[:1], one), 2.0 * c["dim"] * c["nq"] * live_d)
    launches = M.maxsim_scores_cuda.launches
    sweep = M.maxsim_scores_cuda(q120, d, lens120, d_lens)
    n_launch = M.maxsim_scores_cuda.launches - launches
    stacked = torch.cat([M.maxsim_scores_cuda(q120[i: i + 1], d, lens120[:1], d_lens)
                         for i in range(120)])
    require(torch.equal(sweep, stacked), "K1: 120 queries differ from 120 calls of one")
    head = M.maxsim_scores_reference(q120, d[:128], lens120, d_lens[:128])
    live_h = d_lens[:128] > 0
    require(torch.allclose(sweep[:, :128][:, live_h], head[:, live_h], rtol=1e-3, atol=1e-3),
            "K1: 120 queries differ from the plain version on the first 128 pages")
    b120_ms = graph_ms(lambda: M.maxsim_scores_cuda(q120, d, lens120, d_lens), iters=5)
    b120_bound, b120_by = bound(k1_bytes(q120, sweep), 2.0 * c["dim"] * 120 * c["nq"] * live_d)
    reads_ms = n_launch * live_d * c["dim"] * 2 / HBM_BPS * 1e3
    print(f"[kernels] K1 maxsim B = 1: graph replay {b1_ms:.4f} ms, bound {b1_bound:.4f} ms | "
          f"B = 120 ({n_launch} launches of {M.ROWS_PER_LAUNCH} rows): graph replay "
          f"{b120_ms:.3f} ms, bound {b120_bound:.3f} ms ({b120_by}; the corpus read once a "
          f"launch: {reads_ms:.3f} ms), bit for bit 120 calls of one, plain on 128 pages "
          f"within rtol 1e-3", flush=True)
    del sweep, stacked, head, q120
    torch.cuda.empty_cache()

    # K1's CUDA-core kernel: float32 pages (the tensor-core one takes bf16)
    d32 = d[:256].float()
    cc = M.maxsim_scores_cuda.cuda_core_launches
    got32 = M.maxsim_scores_cuda(q32, d32, q_lens, d_lens[:256])
    require(M.maxsim_scores_cuda.cuda_core_launches == cc + 1,
            "K1: float32 pages did not take the CUDA-core kernel")
    want32 = M.maxsim_scores_reference(q32, d32, q_lens, d_lens[:256])
    live32 = live[:256]
    require(torch.allclose(got32[:, live32], want32[:, live32], rtol=1e-4, atol=1e-4),
            "K1: the float32 CUDA-core kernel differs from the plain version")
    print(f"[kernels] K1 maxsim float32 {list(q32.shape)}x{list(d32.shape)} on the CUDA-core "
          f"kernel: max|err| {float((got32 - want32)[:, live32].abs().max()):.3g} (rtol 1e-4)",
          flush=True)
    del d32, got32, want32, got
    torch.cuda.empty_cache()

    # K4: float32 queries against the same corpus quantized to int8 codes + scales
    codes, scales = M.quantize_corpus_int8(d)
    del d
    torch.cuda.empty_cache()
    tc = M.maxsim_scores_int8_cuda.tensor_core_launches
    got = M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens, d_lens)
    require(M.maxsim_scores_int8_cuda.tensor_core_launches == tc + 1,
            "K4: int8 codes with DIM % 16 == 0 did not take the tensor-core path")
    want = M.maxsim_scores_int8_reference(q32, codes, scales, q_lens, d_lens)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "K4: non-finite score")
    require(torch.allclose(got[:, live], want[:, live], rtol=1e-4, atol=0),
            "K4: scores differ from the plain version beyond rtol 1e-4")
    require(torch.allclose(got[:, ~live].double(), empty_want.expand(-1, int((~live).sum())),
                           rtol=1e-6, atol=0), "K4: empty pages do not score -q_len * 1e30")
    k4_err = float((got[:, live] - want[:, live]).abs().max())
    kv, ki = topk_with_stable_ties(got, 5)
    pv, pi = topk_with_stable_ties(want, 5)
    gap = (want.gather(1, ki.long()) - pv).abs()
    require(bool((gap <= 1e-4 * pv.abs()).all()),
            "K4: top-5 differs from the plain version beyond near-ties")
    require(torch.equal(M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens, d_lens), got),
            "K4: a repeated call differs")
    require(torch.equal(M.maxsim_scores_int8_cuda(q32, codes[:odd], scales[:odd], q_lens,
                                                  d_lens[:odd]), got[:, :odd]),
            "K4: an odd page count differs")
    one = M.maxsim_scores_int8_cuda(q32[:1], codes, scales, lens1, d_lens)
    require(torch.equal(one, got[:1]), "K4: B = 1 differs from its row of the batch")
    k_ms, p_ms = timed_pair(torch, lambda: M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens,
                                                                     d_lens),
                            lambda: M.maxsim_scores_int8_reference(q32, codes, scales, q_lens,
                                                                   d_lens), iters=5)
    g_ms = graph_ms(lambda: M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens, d_lens),
                    iters=20)
    b1_ms = graph_ms(lambda: M.maxsim_scores_int8_cuda(q32[:1], codes, scales, lens1, d_lens),
                     iters=20)

    def k4_bytes(qq, out):
        return live_d * (c["dim"] + 4) + qq.numel() * 4 + out.numel() * 4

    results["maxsim_int8"] = row(k4_err, g_ms, p_ms, k4_bytes(q32, got),
                                 2.0 * c["dim"] * float(q_lens.sum()) * live_d)
    b1_bound, _ = bound(k4_bytes(q32[:1], one), 2.0 * c["dim"] * c["nq"] * live_d)
    top_same = bool((ki == pi).all())
    print(f"[kernels] K4 maxsim_int8 {list(q32.shape)} f32 x {list(codes.shape)} int8 + scales: "
          f"max|err| {k4_err:.3g} (rtol 1e-4), empty pages exact, top-5 "
          f"{'identical' if top_same else 'equal up to near-ties'}, repeat / odd page count / "
          f"B = 1 bit-identical | graph replay {g_ms:.4f} ms (eager {k_ms:.4f}), plain "
          f"{p_ms:.3f} ms, bound {results['maxsim_int8']['bound_ms']:.4f} ms | B = 1: graph "
          f"replay {b1_ms:.4f} ms, bound {b1_bound:.4f} ms", flush=True)
    del codes, scales, got, want, one
    torch.cuda.empty_cache()

    # K2: SigLIP-So400m self-attention [8, 1024, 16, 72] bf16, plus masked cases
    c = K2
    shape = (c["b"], c["s"], c["h"], c["d"])
    qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    scale = c["d"] ** -0.5
    tc = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(*qkv, scale=scale)
    require(A.fused_attention_cuda.tensor_core_launches == tc + 1,
            "K2: bf16 with D % 8 == 0 did not take the tensor-core path")
    want = A.attention_reference(*qkv, scale=scale)
    k2_err = float((got.float() - want.float()).abs().max())
    require(k2_err <= 2e-2, f"K2: max|err| {k2_err} > 2e-2")
    # small masked cases: float32 (CUDA cores), bf16 D = 24 (tensor cores), D = 20 (CUDA cores)
    for dtype, d, atol, tensor_core in ((torch.float32, 24, 1e-4, False),
                                        (torch.bfloat16, 24, 2e-2, True),
                                        (torch.bfloat16, 20, 2e-2, False)):
        sq = [torch.randn((2, 40, 3, d), generator=g, device=dev).to(dtype) for _ in range(3)]
        lens = torch.tensor([40, 17], dtype=torch.int32, device=dev)
        valid = torch.rand(2, 40, generator=g, device=dev) > 0.4
        valid[1] = False  # a row with every key masked: uniform weights
        for kw in (dict(kv_lens=lens), dict(kv_valid=valid), dict(causal=True),
                   dict(kv_lens=lens, kv_valid=valid, causal=True)):
            tc = A.fused_attention_cuda.tensor_core_launches
            a = A.fused_attention_cuda(*sq, scale=0.2, **kw)
            require(A.fused_attention_cuda.tensor_core_launches == tc + tensor_core,
                    f"K2 small case {dtype} D={d} took the wrong path")
            b = A.attention_reference(*sq, scale=0.2, **kw)
            err = float((a.float() - b.float()).abs().max())
            require(err <= atol, f"K2 small case {dtype} D={d} {sorted(kw)}: max|err| {err} > "
                                 f"{atol}")
    k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(*qkv, scale=scale),
                            lambda: A.attention_reference(*qkv, scale=scale), iters=10)
    # the library call: scaled_dot_product_attention on the same tensors, [B, H, S, D] views
    qt, kt, vt = (x.transpose(1, 2) for x in qkv)
    lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                      iters=10)
    results["attention"] = row(k2_err, k_ms, p_ms, 4 * qkv[0].numel() * 2,
                               4.0 * c["b"] * c["h"] * c["s"] ** 2 * c["d"], library_ms=lib_ms)
    r = results["attention"]
    print(f"[kernels] K2 attention {list(shape)} bf16 (tensor cores, "
          f"{A.block_rows(torch.bfloat16, c['s'], c['d'])}-row blocks): max|err| {k2_err:.3g} "
          f"(atol 2e-2); kv_lens/kv_valid/causal cases pass on both paths | kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})", flush=True)
    del qkv, got, want
    torch.cuda.empty_cache()

    results.update(normalize_kernel(torch, g))
    results.update(fused_layer_kernels(torch, g))
    results.update(window_attention_kernel(torch, g))
    results.update(generation_kernels(torch, g))
    paligemma_kernels(torch, g, results)
    gemma3_prefill_kernels(torch, g)
    # its own generator: the inputs drawn from g above stay as they were
    g3 = torch.Generator(device=dev).manual_seed(seed + 3)
    results.update(gemma3_tower_attention(torch, g3))
    return results


def gemma3_tower_attention(torch, g):
    """K2 at the shape phase 8 gives it: Gemma-3's SigLIP-So400m at 896 px,
    5 images (exp-02's top 5) of 4,096 patches, ``[5, 4096, 16, 72]`` bf16,
    no mask. The plain version runs one image at a time (its float32 scores
    are 1 GiB an image); the kernel must take its tensor-core path, stay
    within ``K2_GEMMA3_ATOL`` and repeat bit for bit. SDPA on the same tensors
    beside."""
    from multimodal_colpali_tpu_torch._timing import eager_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import attention as A

    c = K2_GEMMA3
    dev = torch.device("cuda")
    shape = (c["b"], c["s"], c["h"], c["d"])
    qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    scale = c["d"] ** -0.5
    tc = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(*qkv, scale=scale)
    require(A.fused_attention_cuda.tensor_core_launches == tc + 1,
            "K2 at the Gemma-3 tower's shape did not take the tensor-core path")

    def plain():
        return torch.cat([A.attention_reference(*(x[i: i + 1] for x in qkv), scale=scale)
                          for i in range(c["b"])])

    want = plain()
    err = float((got.float() - want.float()).abs().max())
    require(err <= K2_GEMMA3_ATOL, f"K2 at [{', '.join(map(str, shape))}]: max|err| {err} > "
                                   f"{K2_GEMMA3_ATOL}")
    require(torch.equal(A.fused_attention_cuda(*qkv, scale=scale), got),
            "K2 at the Gemma-3 tower's shape: a repeated call differs")
    del want
    torch.cuda.empty_cache()
    k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(*qkv, scale=scale), plain,
                            iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in qkv)
    lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=5)
    r = row(err, k_ms, p_ms, 4 * qkv[0].numel() * 2,
            4.0 * c["b"] * c["h"] * c["s"] ** 2 * c["d"], library_ms=lib_ms)
    print(f"[kernels] K2 attention at the Gemma-3 tower's shape {list(shape)} bf16 (tensor "
          f"cores, {A.block_rows(torch.bfloat16, c['s'], c['d'])}-row blocks): max|err| "
          f"{err:.3g} (atol {K2_GEMMA3_ATOL}), repeat bit-identical | kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms (one image at a time), scaled_dot_product_attention {lib_ms:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
          f"{4.0 * c['b'] * c['h'] * c['s'] ** 2 * c['d'] / k_ms / 1e9:.1f} TFLOP/s", flush=True)
    del qkv, got
    torch.cuda.empty_cache()
    return {"attention.gemma3_tower": r}


def normalize_kernel(torch, g):
    """K3 at [8, 448, 448, 3]: within one bf16 ulp of the plain version, also
    for every byte value in each channel position under (0.5, 0.5, 0.5) and
    ImageNet's statistics; a repeat bit-identical; graph replays cycling
    over 12 input sets (57.8 MB of pixels alone, past the 50 MB L2), eager
    beside."""
    from multimodal_colpali_tpu_torch._timing import cycle, graph_ms
    from multimodal_colpali_tpu_torch.ops import preprocess as PP

    c, dev = K3, torch.device("cuda")
    xs = [torch.randint(0, 256, (c["b"], c["size"], c["size"], 3), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8) for _ in range(c["sets"])]
    x, mean, std = xs[0], (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    got = PP.normalize_images_cuda(x, mean, std)
    want = PP.normalize_images_reference(x, mean, std)
    ulps = int(bf16_ulps(torch, got, want).max())
    require(ulps <= 1, f"K3: {ulps} bf16 ulps from the plain version (limit 1)")
    require(torch.equal(PP.normalize_images_cuda(x, mean, std).view(torch.int16),
                        got.view(torch.int16)), "K3: a repeated call is not bit-identical")
    table = torch.arange(256, device=dev, dtype=torch.uint8)[None, :, None, None].expand(
        1, 256, 1, 3).contiguous()
    for m, s in ((mean, std), ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))):
        t_ulps = int(bf16_ulps(torch, PP.normalize_images_cuda(table, m, s),
                               PP.normalize_images_reference(table, m, s)).max())
        require(t_ulps <= 1, f"K3: {t_ulps} bf16 ulps on the byte table under {m}, {s}")
    k3_err = float((got.float() - want.float()).abs().max())
    k_ms = graph_ms(cycle([lambda x=x: PP.normalize_images_cuda(x, mean, std) for x in xs]), 20)
    eager, p_ms = timed_pair(torch, lambda: PP.normalize_images_cuda(x, mean, std),
                             lambda: PP.normalize_images_reference(x, mean, std), iters=20)
    r = row(k3_err, k_ms, p_ms, 3 * x.numel(), 2.0 * x.numel(), F32_FLOPS)
    r["eager_ms"] = eager
    print(f"[kernels] K3 normalize {list(x.shape)} u8->bf16: max {ulps} ulp, byte table "
          f"within 1 ulp under both statistics, repeat bit-identical, max|err| {k3_err:.3g} | "
          f"kernel {k_ms:.4f} ms (graph, {c['sets']} input sets), eager {eager:.4f} ms, plain "
          f"{p_ms:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return {"normalize": r}


def window_attention_kernel(torch, g):
    """K6 at ColFlor's four DaViT stage shapes in bf16 (the ring kernel; graph
    replays, a repeat bit-identical) and at stage 0 in float32."""
    from multimodal_colpali_tpu_torch._timing import graph_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    dev = torch.device("cuda")
    s, d = K6["s"], K6["d"]
    scale = d ** -0.5
    qkv = [torch.randn((K6["n"], s, d), generator=g, device=dev) for _ in range(3)]
    got = WA.window_attention_cuda(*qkv, scale=scale)
    want = WA.window_attention_reference(*qkv, scale=scale)
    f32_err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
            f"K6 float32: max|err| {f32_err} beyond atol and rtol 1e-5")
    del qkv, got, want
    grid = WA.ring_grid()
    r, lines = None, []
    for stage, n in enumerate(K6_STAGES):
        qkv = [torch.randn((n, s, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3)]
        ring = WA.window_attention_cuda.ring_launches
        got = WA.window_attention_cuda(*qkv, scale=scale)
        require(WA.window_attention_cuda.ring_launches == ring + 1,
                f"K6 [{n},{s},{d}] bf16 did not take the ring kernel")
        want = WA.window_attention_reference(*qkv, scale=scale)
        torch.cuda.synchronize()
        require(got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all()),
                f"K6 [{n},{s},{d}]: wrong dtype or non-finite output")
        err = float((got.float() - want.float()).abs().max())
        require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
                f"K6 [{n},{s},{d}] bf16: max|err| {err} beyond atol and rtol 2e-2")
        require(torch.equal(WA.window_attention_cuda(*qkv, scale=scale).view(torch.int16),
                            got.view(torch.int16)),
                f"K6 [{n},{s},{d}]: a repeated call is not bit-identical")
        k_ms = graph_ms(lambda: WA.window_attention_cuda(*qkv, scale=scale), 20)
        # the library call: scaled_dot_product_attention on the same tensors as [N, 1, S, D]
        qt, kt, vt = (x[:, None] for x in qkv)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20)
        nbytes = 4 * qkv[0].numel() * 2
        if stage == 0:
            _, p_ms = timed_pair(torch, lambda: WA.window_attention_cuda(*qkv, scale=scale),
                                 lambda: WA.window_attention_reference(*qkv, scale=scale),
                                 iters=10)
            r = row(err, k_ms, p_ms, nbytes, 4.0 * n * s * s * d, library_ms=lib_ms)
            r["f32_max_abs_err"] = f32_err
            r["stages_ms"] = []
        r["stages_ms"].append(k_ms)
        lines.append(f"[{n},{s},{d}] {k_ms:.4f} ms ({nbytes / k_ms * 1e-9:.2f} TB/s, bound "
                     f"{bound(nbytes, 0)[0]:.4f}), sdpa {lib_ms:.4f}, max|err| {err:.3g}")
        del qkv, qt, kt, vt, got, want
        torch.cuda.empty_cache()
    print(f"[kernels] K6 window_attention bf16 on the ring kernel (grid {grid}), atol + rtol "
          f"2e-2, repeat bit-identical; float32 [{K6['n']},{s},{d}] max|err| {f32_err:.3g} "
          f"(1e-5) | plain {r['plain_ms']:.3f} ms | graph replays by stage: "
          + "; ".join(lines), flush=True)
    return {"window_attention": r}


def epilogue_step(torch, product, epilogue):
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


def gemm_bound_close(torch, got, want, product=None, epilogue="bias"):
    """(ok, max excess): per element within 2^-7|want| + 2e-3, plus, for
    gelu and the residual, which act on the product already rounded to bf16,
    one bf16 step of the product through the epilogue (tests/test_torch_cuda.py's
    bound)."""
    err = (got.float() - want.float()).abs()
    lim = 2.0 ** -7 * want.float().abs() + 2e-3
    if product is not None:
        lim = lim + epilogue_step(torch, product, epilogue)
    return bool((err <= lim).all()), float((err - lim).max())


def grid_gemm_case(torch, g, m, k, nseg, segs, ln, epilogue):
    """A GEMM's operands on a grid: small integers at power-of-two scales,
    so every float32 sum is exact in any order. LayerNorm rows are mean ± c
    with c a power of two (eps 0): each normalizes to sign · g + b exactly,
    returned as the last item (None without a LayerNorm); F.layer_norm's own
    rounding can leave ~1e-8 where that is 0, so the plain version is taken
    on the exact normalized rows."""
    dev = torch.device("cuda")

    def grid(*shape, lo=-4, hi=5, scale=1.0):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float() * scale

    kw, xn = {}, None
    if ln:
        sign = torch.ones(m, k, device=dev)
        sign[:, 1::2] = -1.0
        sign = sign[:, torch.randperm(k, generator=g, device=dev)]
        c = 2.0 ** torch.randint(-2, 3, (m, 1), generator=g, device=dev).float()
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


def fused_layer_kernels(torch, g):
    """K5a-c at ColSmol's SigLIP layer with seeded random bf16 weights, then
    the four GEMMs they are made of and the LayerNorm statistics launch,
    each alone at M = 8,192, against their plain versions."""
    from multimodal_colpali_tpu_torch._timing import graph_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    c = K5
    dev = torch.device("cuda")
    h, inter = c["h"], c["inter"]

    def w(o, i):
        return (torch.randn(o, i, generator=g, device=dev) * i ** -0.5).to(torch.bfloat16)

    def v(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).to(torch.bfloat16)

    ln1, attn = [v(h, 1.0), v(h)], [w(h, h), v(h), w(h, h), v(h), w(h, h), v(h), w(h, h), v(h)]
    ln2, mlp = [v(h, 1.0), v(h)], [w(inter, h), v(inter), w(h, inter), v(h)]
    x = torch.randn(c["b"], c["s"], h, generator=g, device=dev).to(torch.bfloat16)
    heads = dict(heads=c["heads"])
    cases = {
        "vit_layer": ("K5a", FL.fused_vit_layer_cuda, FL.fused_vit_layer_reference,
                      ln1 + attn + ln2 + mlp, heads),
        "attn_block": ("K5b", FL.fused_vit_attention_block_cuda,
                       FL.fused_vit_attention_block_reference, ln1 + attn, heads),
        "mlp_block": ("K5c", FL.fused_mlp_block_cuda, FL.fused_mlp_block_reference,
                      ln2 + mlp, {}),
    }
    results = {}
    m = c["b"] * c["s"]
    for name, (tag, kernel, plain, args, kw) in cases.items():
        wg = FL.fused_gemm_cuda.wgmma_launches
        got = kernel(x, *args, **kw)
        want = plain(x, *args, **kw)
        torch.cuda.synchronize()
        require(FL.fused_gemm_cuda.wgmma_launches == wg + (4 if name == "vit_layer" else 2),
                f"{tag}: its GEMMs did not all take gemm_wgmma")
        require(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        # tests/test_fused_layer.py's tolerance: bf16 intermediates may round apart
        require(torch.allclose(got.float(), want.float(), rtol=3e-2, atol=3e-2),
                f"{tag}: max|err| {err} beyond atol 3e-2 + rtol 3e-2")
        e_ms, p_ms = timed_pair(torch, lambda: kernel(x, *args, **kw),
                                lambda: plain(x, *args, **kw), iters=10)
        k_ms = graph_ms(lambda: kernel(x, *args, **kw), iters=10)
        attn_flops = 2.0 * m * h * 4 * h + 4.0 * c["b"] * c["s"] ** 2 * h
        mlp_flops = 4.0 * m * h * inter
        flops = {"vit_layer": attn_flops + mlp_flops, "attn_block": attn_flops,
                 "mlp_block": mlp_flops}[name]
        results[name] = row(err, k_ms, p_ms, sum(a.numel() * a.element_size() for a in args)
                            + 2 * x.numel() * 2, flops)
        print(f"[kernels] {tag} {name} {list(x.shape)} bf16 I={inter} {c['heads']} heads: "
              f"max|err| {err:.3g} (atol 3e-2 + rtol 3e-2) | kernel {k_ms:.4f} ms (CUDA graph; "
              f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, bound "
              f"{results[name]['bound_ms']:.4f} ms", flush=True)
        del got, want

    # the four GEMMs alone: rows M = 8,192 of phase 2's x (fc2 on a gelu-shaped hidden)
    x2d = x.view(m, h)
    hid = F.gelu(torch.randn(m, inter, generator=g, device=dev), approximate="tanh").to(
        torch.bfloat16)
    gemms = {
        "qkv": (x2d, attn[0:6:2], attn[1:6:2], "bias", dict(ln=tuple(ln1), eps=1e-6)),
        "out_proj": (x2d, [attn[6]], [attn[7]], "residual", dict(resid=x2d)),
        "fc1": (x2d, [mlp[0]], [mlp[1]], "gelu", dict(ln=tuple(ln2), eps=1e-6)),
        "fc2": (hid, [mlp[2]], [mlp[3]], "residual", dict(resid=x2d)),
    }
    for role, (a, ws, bs, epi, kw) in gemms.items():
        tag = f"GEMM {role}"
        k, nseg, segs = a.shape[1], ws[0].shape[0], len(ws)
        wg = FL.fused_gemm_cuda.wgmma_launches
        got = FL.fused_gemm_cuda(a, ws, bs, epi, **kw)
        require(FL.fused_gemm_cuda.wgmma_launches == wg + 1, f"{tag}: not on gemm_wgmma")
        # with a LayerNorm: the kernel's normalized A, exactly (an identity
        # weight), within one bf16 step of F.layer_norm's; the product is held on it
        a_ref, kw_ref = a, kw
        if "ln" in kw:
            eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
            a_ref = FL.fused_gemm_cuda(a, [eye], [torch.zeros(k, device=dev)], "bias",
                                       ln=kw["ln"], eps=kw["eps"])[0]
            ref = FL._layernorm(a, *kw["ln"], kw["eps"]).float()
            require(bool(((a_ref.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all()),
                    f"{tag}: the normalized A is not within a bf16 step of F.layer_norm's")
            kw_ref = {kk: vv for kk, vv in kw.items() if kk not in ("ln", "eps")}
            del eye, ref
        want = FL.gemm_reference(a_ref, ws, bs, epi, **kw_ref)
        product = None
        if epi != "bias":   # the product before gelu / the residual, held apart
            bare = {kk: vv for kk, vv in kw.items() if kk != "resid"}
            product = FL.gemm_reference(a_ref, ws, bs, "bias")
            ok, excess = gemm_bound_close(torch, FL.fused_gemm_cuda(a, ws, bs, "bias", **bare),
                                          product)
            require(ok, f"{tag}: the product is {excess} past 2^-7|want| + 2e-3")
        ok, excess = gemm_bound_close(torch, got, want, product, epi)
        require(bool(torch.isfinite(got.float()).all()) and ok,
                f"{tag}: {excess} past its per-element bound")
        require(torch.equal(got, FL.fused_gemm_cuda(a, ws, bs, epi, **kw)),
                f"{tag}: two calls differ")
        ga, gws, gbs, gkw, gxn = grid_gemm_case(torch, g, m, k, nseg, segs, "ln" in kw, epi)
        gk = FL.fused_gemm_cuda(ga, gws, gbs, epi, **gkw)
        if gxn is None:
            gr = FL.gemm_reference(ga, gws, gbs, epi, **gkw)
        else:   # the kernel's normalized rows exactly sign · g + b, and the rest on them
            eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
            require(torch.equal(FL.fused_gemm_cuda(ga, [eye], [torch.zeros(k, device=dev)],
                                                   "bias", **gkw)[0], gxn),
                    f"{tag}: the normalized grid rows are not exact")
            gr = FL.gemm_reference(gxn, gws, gbs, epi, **{kk: vv for kk, vv in gkw.items()
                                                          if kk not in ("ln", "eps")})
            del eye
        if not torch.equal(gk, gr):
            where = (gk != gr).nonzero()[:4].tolist()
            fail(f"{tag}: not bit-exact on grid inputs: {int((gk != gr).sum())} of {gk.numel()} "
                 f"differ, e.g. at {where}: kernel {[float(gk[tuple(i)]) for i in where]}, "
                 f"plain {[float(gr[tuple(i)]) for i in where]}")
        del ga, gws, gbs, gkw, gxn, gk, gr
        err = float((got.float() - want.float()).abs().max())
        e_ms, p_ms = timed_pair(torch, lambda: FL.fused_gemm_cuda(a, ws, bs, epi, **kw),
                                lambda: FL.gemm_reference(a, ws, bs, epi, **kw), iters=10)
        k_ms = graph_ms(lambda: FL.fused_gemm_cuda(a, ws, bs, epi, **kw), iters=20)
        # cuBLAS's bare product on the already-normalized input: less work (no
        # LN, no epilogue), so not the same function; timed only
        an = FL._layernorm(a, *kw["ln"], 1e-6) if "ln" in kw else a
        wcat = torch.cat(ws)
        cublas_ms = graph_ms(lambda: F.linear(an, wcat), iters=20)
        n = nseg * segs
        flops = 2.0 * m * n * k
        nbytes = 2 * (a.numel() + n * k + m * n) + 4 * n + (2 * m * n if "resid" in kw else 0)
        r = results[f"gemm.{role}"] = dict(
            row(err, k_ms, p_ms, nbytes, flops), cublas_bare_ms=cublas_ms)
        plan = FL.gemm_plan(m, nseg, segs, FL._sms(dev))
        step = "" if product is None else f" (+ a bf16 step of the product through {epi})"
        print(f"[kernels] {tag} [{m},{k}] x {segs} x [{nseg},{k}]^T"
              f"{' LN' if 'ln' in kw else ''} + {epi}: bn {plan.bn}, {plan.tiles} tiles on "
              f"{plan.grid} blocks; max|err| {err:.3g}"
              f"{' (on its own normalized A, itself within a bf16 step)' if 'ln' in kw else ''}, "
              f"within 2^-7|want| + 2e-3{step}, bit-exact on grid inputs, repeat "
              f"bit-identical | kernel {k_ms:.4f} ms (CUDA graph; eager call {e_ms:.4f}), "
              f"{flops / k_ms * 1e-9:.1f} TFLOP/s, plain {p_ms:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuBLAS bare product {cublas_ms:.4f} ms",
              flush=True)
        del got, want, product, an, wcat, a_ref

    # the LayerNorm statistics pre-pass alone
    got = FL.ln_stats_cuda(x2d, 1e-6)
    want = FL.ln_stats_reference(x2d, 1e-6)
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            f"ln_stats: max|err| {err} beyond rtol 1e-5 + atol 1e-6")
    require(torch.equal(got, FL.ln_stats_cuda(x2d, 1e-6)), "ln_stats: two calls differ")
    e_ms, p_ms = timed_pair(torch, lambda: FL.ln_stats_cuda(x2d, 1e-6),
                            lambda: FL.ln_stats_reference(x2d, 1e-6), iters=20)
    k_ms = graph_ms(lambda: FL.ln_stats_cuda(x2d, 1e-6), iters=20)
    results["ln_stats"] = row(err, k_ms, p_ms, x2d.numel() * 2 + m * 8, 4.0 * x2d.numel(),
                              F32_FLOPS)
    print(f"[kernels] ln_stats [{m},{h}] bf16: max|err| {err:.3g} (rtol 1e-5 + atol 1e-6), "
          f"repeat bit-identical | kernel {k_ms:.4f} ms (CUDA graph; eager call {e_ms:.4f}), "
          f"plain {p_ms:.3f} ms, bound {results['ln_stats']['bound_ms']:.4f} ms", flush=True)
    del x, x2d, hid
    torch.cuda.empty_cache()
    return results


def paged_kernels(torch, g):
    """K7a and K7b at gemma-3-27b's heads, windows 0 and 1,024: phase 2's case
    (8 slots of up to 4,096 tokens) and the paged batcher's decode step (4
    slots of 2,048 at 309-1,509 tokens, as in the generation breakdown)."""
    from multimodal_colpali_tpu_torch._timing import cycle, graph_ms
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    dev = torch.device("cuda")
    c = K7
    hq, hkv, d, page = c["hq"], c["hkv"], c["d"], c["page"]
    scale = 168.0 ** -0.5                    # gemma-3-27b's query_pre_attn_scalar
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(b, nb, lengths, sets):
        n_pages = b * nb + 1
        q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
        pools = [(torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16),
                  torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16))
                 for _ in range(sets)]
        bt = torch.randperm(n_pages, generator=g, device=dev)[: b * nb].reshape(b, nb)
        if lengths is None:
            lens = torch.randint(1, nb * page + 1, (b,), generator=g, device=dev,
                                 dtype=torch.int32)
            lens[0], lens[1] = 0, nb * page          # an inactive slot, a full one
        else:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return q, pools, bt.to(torch.int32), lens

    # The outputs are softmax-weighted means of N(0, 1) rows, typically a few
    # hundredths, so a fixed atol alone could pass a kernel that drops a whole
    # split of a long slot. Each element is held to RTOL of its own size (the
    # bf16 rounding of the output: 1 ulp is 2^-8..2^-7 of it) plus ATOL (the
    # bf16 rounding of the probabilities, and for K7b's dequantize-first plain
    # version of the K and V rows too, so twice K7a's); a dropped 256-token
    # split moves the 4096-token slot by ~6e-3 rms. The issue's absolute limits
    # stay as floors. Then the same data in float32 (q and pools; K7b's codes
    # unchanged), where only the sum order differs: 1e-4 for K7a, 1e-3 for K7b.
    # bf16 takes the tensor-core path, float32 the CUDA-core path. The kernel
    # is timed as a CUDA-graph replay (a decode-shape call is shorter than its
    # eager launch); the decode step's case cycles over 4 sets of pools, as a
    # step reads each layer's own, so its 25-30 MB of rows are not served from
    # the 50 MB L2 cache.
    rtol = 2.0 ** -7
    shapes = (("phase 2", c["b"], c["nb"], None, 1),
              ("decode step", 4, 128, [309, 709, 1109, 1509], 4))
    results, errs = {}, {"paged_attention": [], "paged_attention_int8": []}
    for label, b, nb, lengths, sets in shapes:
        q, pools, bt, lens = case(b, nb, lengths, sets)
        int8 = [(*PA.quantize_kv_rows(kp), *PA.quantize_kv_rows(vp)) for kp, vp in pools]
        q32, kp32, vp32 = q.float(), pools[0][0].float(), pools[0][1].float()
        splits = PA.split_plan(b, hkv, nb * page, sms)

        def kv_bytes(window, per_row):
            """Bytes of the K and V rows this data needs (a slot of length 0
            reads every gathered V row for its uniform mean)."""
            total = 0
            for n in lens.tolist():
                rows = min(n, window) if window and n else n
                total += (2 * rows if n else nb * page) * hkv * per_row
            return total

        def k7a(q_, kp_, vp_, kernel=True):
            fn = PA.paged_attention_cuda if kernel else PA.paged_attention_reference
            return lambda w: fn(q_, kp_, vp_, bt, lens, scale=scale, window=w)

        def k7b(q_, pools_, kernel=True):
            fn = PA.paged_attention_int8_cuda if kernel else PA.paged_attention_int8_reference
            return lambda w: fn(q_, *pools_, bt, lens, scale=scale, window=w)

        for name, tag, floor, atol, f32_atol, per_row, kern, make in (
                ("paged_attention", "K7a", 2e-2, 2e-3, 1e-4, d * 2, PA.paged_attention_cuda,
                 lambda q_, i, kernel=True, f32=False: k7a(
                     q_, kp32 if f32 else pools[i][0], vp32 if f32 else pools[i][1], kernel)),
                ("paged_attention_int8", "K7b", 0.035, 4e-3, 1e-3, d + 4,
                 PA.paged_attention_int8_cuda,
                 lambda q_, i, kernel=True, f32=False: k7b(q_, int8[i], kernel))):
            call, plain = make(q, 0), make(q, 0, False)
            call32, plain32 = make(q32, 0, f32=True), make(q32, 0, False, f32=True)
            for window in (0, 1024):
                tc, cc = kern.tensor_core_launches, kern.cuda_core_launches
                got, want = call(window).float(), plain(window).float()
                torch.cuda.synchronize()
                require(kern.tensor_core_launches == tc + 1,
                        f"{tag} {label}: bf16 did not take the tensor-core path")
                require(bool(torch.isfinite(got).all()), f"{tag} {label}: non-finite output")
                diff = (got - want).abs()
                err, top = float(diff.max()), float(want.abs().max())
                excess = float((diff - rtol * want.abs()).max())
                require(err <= floor and excess <= atol,
                        f"{tag} {label} window {window}: max|err| {err} (floor {floor}), "
                        f"max(|err| - {rtol:.4g}|want|) {excess} > {atol}; max|want| {top}")
                got32, want32 = call32(window), plain32(window)
                require(kern.cuda_core_launches == cc + 1,
                        f"{tag} {label}: float32 did not take the CUDA-core path")
                err32 = float((got32 - want32).abs().max())
                require(got32.dtype == torch.float32 and err32 <= f32_atol,
                        f"{tag} {label} float32 window {window}: max|err| {err32} > {f32_atol}")
                require(torch.equal(call(window), call(window)),
                        f"{tag} {label} window {window}: two calls differ")
                errs[name].append(err)
                e_ms, p_ms = timed_pair(torch, lambda: call(window), lambda: plain(window),
                                        iters=10)
                k_ms = graph_ms(cycle([lambda i=i: make(q, i)(window)
                                       for i in range(sets)]), iters=20)
                nbytes = kv_bytes(window, per_row) + 2 * q.numel() * 2 + bt.numel() * 4
                rows = sum(min(n, window) if window else n for n in lens.tolist())
                r = row(err, k_ms, p_ms, nbytes, 4.0 * hq * d * rows)
                print(f"[kernels] {tag} {name} {label}: q {list(q.shape)} pools "
                      f"{list(pools[0][0].shape)} window {window}, lengths {lens.tolist()}, "
                      f"{splits} splits: bf16 (tensor cores) max|err| {err:.3g} (floor {floor}) "
                      f"with max|want| {top:.3g}, max(|err| - {rtol:.4g}|want|) {excess:.3g} "
                      f"(limit {atol}); float32 (CUDA cores) max|err| {err32:.3g} (limit "
                      f"{f32_atol}); repeat bit-identical | kernel {k_ms:.4f} ms (CUDA graph; "
                      f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
                results.setdefault(name, r)              # phase 2 at window 0 is the row
                del got, want, got32, want32, diff
        del q, pools, int8, q32, kp32, vp32
        torch.cuda.empty_cache()
    for name in results:
        results[name] = dict(results[name], max_abs_err=max(errs[name]))
    return results


def generation_kernels(torch, g):
    """K7a, K7b, K8a and K8b at gemma-3-27b's decode shapes."""
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    dev = torch.device("cuda")
    results = paged_kernels(torch, g)

    h, inter, vocab = K8["h"], K8["inter"], K8["vocab"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    w_up, w_down = codes(h, inter), codes(inter, h)
    s_up = torch.rand(inter, generator=g, device=dev) * 1e-3
    s_down = torch.rand(h, generator=g, device=dev) * 1e-3
    table = codes(vocab + (-vocab) % 512, h)          # the padded embed codes
    s_tab = torch.rand(table.shape[0], generator=g, device=dev) * 1e-3
    # the yardstick x @ w[N, K]^T * scale[N]: K8b's table as it is, K8a's codes
    # as transposed copies made once
    int8pack = library_op(torch, "_weight_int8pack_mm")
    nk_copy = {id(w_up): w_up.t().contiguous(), id(w_down): w_down.t().contiguous(),
               id(table): table} if int8pack else {}
    # K8a: decode rows (the row), prefill rows at 512 tokens (the prefill row)
    # and at 1,504 (the generation breakdown's prompt) through both projections
    cases = [("int8_matmul_kn", "K8a", 8, w_up, s_up, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 512, w_up, s_up, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 1504, w_up, s_up, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 1504, w_down, s_down, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 8, w_down, s_down, False, torch.bfloat16),
             ("int8_matmul_nk", "K8b", 8, table, s_tab, True, torch.float32)]
    for name, tag, m, w, sc, nk, out in cases:
        k = w.shape[1] if nk else w.shape[0]
        n = w.shape[0] if nk else w.shape[1]
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        kernel = IM.int8_matmul_nk_cuda if nk else IM.int8_matmul_kn_cuda
        call = lambda: kernel(x, w, sc, out_dtype=out)  # noqa: E731
        plain = lambda: IM.int8_matmul_reference(x, w, sc, transpose_codes=nk)  # noqa: E731
        tile = "decode" if m <= 16 else "prefill"
        before = None if nk else getattr(kernel, f"{tile}_launches")
        got, want = call().float(), plain().float()
        torch.cuda.synchronize()
        require(nk or getattr(kernel, f"{tile}_launches") == before + 1,
                f"{tag} [{m}, {k}] did not take its {tile} tile")
        err = float((got - want).abs().max())
        limit = 0.02 * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"{tag} [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
        require(torch.equal(call(), call()), f"{tag} [{m}, {k}]: two calls differ")
        e_ms, p_ms = timed_pair(torch, call, plain, iters=10)
        k_ms = graph_ms(call, iters=20)
        lib_ms = mm_ms = None
        if int8pack:
            w_nk, s_x = nk_copy[id(w)], sc.to(x.dtype)
            lib_ms = eager_ms(lambda: int8pack(x, w_nk, s_x), iters=10 if m <= 16 else 2)
        if not nk and m > 16:     # context: cuBLAS on the weight already dequantized
            w_bf16 = w.to(torch.bfloat16)
            mm_ms = graph_ms(lambda: torch.mm(x, w_bf16), iters=10)
            del w_bf16
        r = row(err, k_ms, p_ms, w.numel() + sc.numel() * 4 + x.numel() * 2
                + m * n * (4 if out == torch.float32 else 2), 2.0 * m * k * n, library_ms=lib_ms)
        lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none on this torch"
        mm = f", bf16 torch.mm on the dequantized weight {mm_ms:.4f} ms" if mm_ms else ""
        print(f"[kernels] {tag} {name} x [{m}, {k}] bf16 x codes {list(w.shape)} int8 -> "
              f"{str(out).split('.')[-1]}{'' if nk else f' ({tile} tile)'}: max|err| {err:.3g} "
              f"(limit 2% of max, {limit:.3g}), repeat bit-identical, "
              f"{IM.split_count(m, n, k, sms, nk=nk)} K splits | kernel {k_ms:.4f} ms (CUDA graph; "
              f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, _weight_int8pack_mm {lib}{mm}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
        # the first decode shape is the row, the first prefill shape the prefill row
        results.setdefault(name if m <= 16 else f"{name}.prefill", r)
        del x, got, want
    # integer codes and x on a 2^-4 grid, a power-of-two scale: every product
    # and partial sum is exact in float32, so K8a must equal the float32 plain
    # product bit for bit on both tiles
    for m in (8, 200):
        c = codes(h, 1024)
        x = (torch.randint(-8, 8, (m, h), generator=g, device=dev) * 0.0625).to(torch.bfloat16)
        sc = torch.full((1024,), 2.0 ** -7, device=dev)
        got = IM.int8_matmul_kn_cuda(x, c, sc, out_dtype=torch.float32)
        require(torch.equal(got, IM.int8_matmul_reference(x.float(), c, sc)),
                f"K8a [{m}, {h}] differs from the plain version on grid inputs")
    print(f"[kernels] K8a on grid inputs [8 | 200, {h}] x [{h}, 1024]: both tiles equal the plain "
          f"version bit for bit", flush=True)
    del w_up, w_down, table, nk_copy, c, x, got
    torch.cuda.empty_cache()
    results.update(int4_kernels(torch, g, sms))
    return results


def paligemma_kernels(torch, g, results) -> None:
    """K7a, K8a (both tiles) and K8b at the shapes phase 7 gives them:
    PaliGemma's Gemma-2B LM (8 query heads over 1 KV head of 256; hidden
    2,048, MLP 16,384, vocab 257,216) in the paged batcher's 4 slots of
    6,144 tokens, pages of 16, at the lengths of a 1-page and a 5-page image
    prompt and of two text prompts. Each is held against its plain version
    at phase 2's limits; K7a's error joins its row's max_abs_err."""
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    dev = torch.device("cuda")
    cfg = RETRIEVER_CONFIGS[COLPALI]()
    t = cfg.text
    h, inter, hq, hkv, d = (t.hidden_size, t.intermediate_size, t.num_attention_heads,
                            t.num_key_value_heads, t.head_dim)
    b, page = IMG["slots"], IMG["page"]
    nb = IMG["max_seq_len"] // page
    patches = cfg.vision.num_patches
    lengths = [patches + 40, TOP_K * patches + 40, 330, 730]
    n_pages = b * nb + 1
    q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    bt = torch.randperm(n_pages, generator=g, device=dev)[: b * nb].reshape(b, nb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kern = PA.paged_attention_cuda
    tc = kern.tensor_core_launches
    got = kern(q, kp, vp, bt, lens, scale=d ** -0.5).float()
    want = PA.paged_attention_reference(q, kp, vp, bt, lens, scale=d ** -0.5).float()
    torch.cuda.synchronize()
    require(kern.tensor_core_launches == tc + 1, "K7a PaliGemma: bf16 did not take the "
                                                 "tensor-core path")
    diff = (got - want).abs()
    err, excess = float(diff.max()), float((diff - 2.0 ** -7 * want.abs()).max())
    require(bool(torch.isfinite(got).all()) and err <= 2e-2 and excess <= 2e-3,
            f"K7a PaliGemma q {list(q.shape)} lengths {lengths}: max|err| {err} (floor 2e-2), "
            f"max(|err| - 2^-7|want|) {excess} > 2e-3")
    results["paged_attention"]["max_abs_err"] = max(results["paged_attention"]["max_abs_err"],
                                                    err)
    print(f"[kernels] K7a paged_attention at phase 7's shapes: q {list(q.shape)} pools "
          f"{list(kp.shape)}, lengths {lengths}: bf16 (tensor cores) max|err| {err:.3g} (floor "
          f"2e-2), max(|err| - 2^-7|want|) {excess:.3g} (limit 2e-3)", flush=True)
    del q, kp, vp, bt, got, want, diff

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    # decode rows: every projection of the layer (q/o, k/v, gate/up, down); prefill
    # rows of the 1-page and 5-page prompts through the MLP
    kn = [(b, h, h), (b, h, hkv * d), (b, h, inter), (b, inter, h),
          (lengths[0], h, inter), (lengths[0], inter, h),
          (lengths[1], h, inter), (lengths[1], inter, h)]
    cases = [(m, codes(k, n), False, torch.bfloat16) for m, k, n in kn]
    cases.append((b, codes(t.vocab_size + (-t.vocab_size) % 512, h), True, torch.float32))
    notes = []
    for m, w, nk, out in cases:
        k = w.shape[1] if nk else w.shape[0]
        sc = torch.rand(w.shape[0] if nk else w.shape[1], generator=g, device=dev) * 1e-3
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        kernel = IM.int8_matmul_nk_cuda if nk else IM.int8_matmul_kn_cuda
        tile = "decode" if m <= IM.DECODE_ROWS else "prefill"
        before = kernel.launches if nk else getattr(kernel, f"{tile}_launches")
        got = kernel(x, w, sc, out_dtype=out).float()
        want = IM.int8_matmul_reference(x, w, sc, transpose_codes=nk).float()
        torch.cuda.synchronize()
        tag = "K8b" if nk else f"K8a ({tile} tile)"
        require((kernel.launches if nk else getattr(kernel, f"{tile}_launches")) == before + 1,
                f"{tag} [{m}, {k}] x {list(w.shape)} did not launch")
        err = float((got - want).abs().max())
        limit = 0.02 * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"{tag} [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
        notes.append(f"{tag} [{m}, {k}] x {list(w.shape)} {err:.3g} (limit {limit:.3g})")
        del x, got, want, w, sc
    print(f"[kernels] K8a/K8b at phase 7's int8 shapes, max|err| against the plain version: "
          f"{'; '.join(notes)}", flush=True)
    torch.cuda.empty_cache()


def gemma3_prefill_kernels(torch, g) -> None:
    """K8a's prefill tile at the rows phase 8 gives it under int8 weights:
    gemma-3-27b's attention projections (q, k/v, o) and MLP (gate/up, down)
    at the bucketed rows of its 1-image and 5-image prompts and of the second
    question's tail after the pages it shares with the first, each held
    against its plain version at phase 2's limit (2% of the output's max)."""
    from types import SimpleNamespace
    from multimodal_colpali_tpu_torch.generation import Gemma3MMEngine, ModuloTokenizer
    from multimodal_colpali_tpu_torch.models.registry import GEMMA3_MM_CONFIGS
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    dev = torch.device("cuda")
    cfg = GEMMA3_MM_CONFIGS[GEN_MODEL]()
    t, page = cfg.text, G3_IMG["page"]
    tok = ModuloTokenizer(t.vocab_size)
    prompts = [Gemma3MMEngine.build_mm_prompt(SimpleNamespace(cfg=cfg), tok.encode(q),
                                              bos_id=tok.bos_id, newline_ids=tok.encode("\n"),
                                              n_images=n, **G3_IMG["marks"])
               for _, n, q in G3_ASKS]
    first, second = prompts[1], prompts[2]        # the two questions over the 5 images
    common = next(i for i, (a, b) in enumerate(zip(first, second)) if a != b)
    tail = len(second) - min(common // page, (len(second) - 1) // page) * page
    rows = sorted({-(-n // 16) * 16 for n in [len(p) for p in prompts] + [tail]})
    h, inter, qd, kvd = (t.hidden_size, t.intermediate_size,
                         t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim)
    kernel = IM.int8_matmul_kn_cuda
    notes = []
    for k, n in ((h, qd), (h, kvd), (qd, h), (h, inter), (inter, h)):
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=g, device=dev) * 1e-3
        for m in rows:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            before = kernel.prefill_launches
            got = kernel(x, w, sc, out_dtype=torch.bfloat16).float()
            want = IM.int8_matmul_reference(x, w, sc).float()
            torch.cuda.synchronize()
            require(kernel.prefill_launches == before + 1,
                    f"K8a [{m}, {k}] x {list(w.shape)} did not take its prefill tile")
            err = float((got - want).abs().max())
            limit = 0.02 * float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and err <= limit,
                    f"K8a [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
            notes.append(f"[{m}, {k}] x {list(w.shape)} {err:.3g} (limit {limit:.3g})")
            del x, got, want
        del w, sc
    print(f"[kernels] K8a (prefill tile) at phase 8's int8 prefill rows {rows} (prompts of "
          f"{[len(p) for p in prompts]} tokens, a {tail}-token tail), max|err| against the plain "
          f"version: {'; '.join(notes)}", flush=True)
    torch.cuda.empty_cache()


def int4pack_operands(torch, packed, scale, group: int):
    """K9's weight in the layout of ``torch._weight_int4pack_mm``: the codes
    of ``quantize_int4``'s group-split bytes as [N, K] nibbles, two to a byte
    (even k in the high nibble), through ``_convert_weight_to_int4pack``, and
    [K/G, N, 2] bf16 scales with zero points 0 (its dequantization is
    (q - 8) * scale + zero, K9's)."""
    half, n = packed.shape[0], packed.shape[1]
    groups = scale.shape[0]
    lo, hi = (packed & 15).view(groups, -1, n), (packed >> 4).view(groups, -1, n)
    codes = torch.cat([lo, hi], dim=1).reshape(2 * half, n).t()     # [N, K]
    nk = (codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8).contiguous()
    wp = torch._convert_weight_to_int4pack(nk, 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
    return wp, sz


def int4_kernels(torch, g, sms: int):
    """K9 at gemma-3-27b's projections, group 256: decode rows of the up and
    down projections, prefill rows, and exact equality on grid weights."""
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops.quant import quantize_int4

    dev = torch.device("cuda")
    h, inter, group = K8["h"], K8["inter"], 256

    def weights(k, n):
        packed = torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                               dtype=torch.int32).to(torch.uint8)
        return packed, torch.rand(k // group, n, generator=g, device=dev) * 1e-2

    up, down = weights(h, inter), weights(inter, h)
    int4pack = library_op(torch, "_weight_int4pack_mm")
    results = {}
    # decode rows (the row), prefill rows at 512 tokens (the prefill row) and at 1,504
    for m, (packed, sc) in ((8, up), (8, down), (512, up), (1504, up), (1504, down)):
        k, n = 2 * packed.shape[0], packed.shape[1]
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        call = lambda: I4.int4_matmul_kn_cuda(x, packed, sc)  # noqa: E731
        plain = lambda: I4.int4_matmul_reference(x, packed, sc)  # noqa: E731
        tile = "decode_launches" if m <= 16 else "prefill_launches"
        before = getattr(I4.int4_matmul_kn_cuda, tile)
        got, want = call().float(), plain().float()
        torch.cuda.synchronize()
        require(getattr(I4.int4_matmul_kn_cuda, tile) == before + 1,
                f"K9 [{m}, {k}] did not take its {tile.split('_')[0]} tile")
        err = float((got - want).abs().max())
        limit = 0.02 * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"K9 [{m}, {k}] x packed {list(packed.shape)}: max|err| {err} > 2% of max {limit}")
        require(torch.equal(call(), call()), f"K9 [{m}, {k}]: two calls differ")
        e_ms, p_ms = timed_pair(torch, call, plain, iters=10)
        k_ms = graph_ms(call, iters=20)
        lib_ms = lib_note = mm_ms = None
        if int4pack:
            wp, sz = int4pack_operands(torch, packed, sc, group)   # the repack, once
            lib_ms = eager_ms(lambda: int4pack(x, wp, group, sz), iters=10)
            lib_note = float((int4pack(x, wp, group, sz).float() - want).abs().max())
            del wp, sz
        if m > 16:     # context: cuBLAS on the weight already dequantized
            from multimodal_colpali_tpu_torch.ops.quant import dequantize_int4

            w_bf16 = dequantize_int4({"q4": packed, "scale": sc}, torch.bfloat16)
            mm_ms = graph_ms(lambda: torch.mm(x, w_bf16), iters=10)
            del w_bf16
        r = row(err, k_ms, p_ms, packed.numel() + sc.numel() * 4 + x.numel() * 2 + m * n * 2,
                2.0 * m * k * n, library_ms=lib_ms)
        lib = (f"{lib_ms:.3f} ms (max|diff| {lib_note:.3g})" if lib_ms is not None
               else "none on this torch")
        mm = f", bf16 torch.mm on the dequantized weight {mm_ms:.4f} ms" if mm_ms else ""
        print(f"[kernels] K9 int4_matmul_kn x [{m}, {k}] bf16 x packed {list(packed.shape)} "
              f"uint8 + scales {list(sc.shape)} -> bf16 ({tile.split('_')[0]} tile): max|err| "
              f"{err:.3g} (limit 2% of max, {limit:.3g}), repeat bit-identical, "
              f"{I4.split_count(m, n, k, sms)} K splits | kernel {k_ms:.4f} ms (CUDA graph; "
              f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, _weight_int4pack_mm {lib}{mm}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        results.setdefault("int4_matmul_kn" if m <= 16 else "int4_matmul_kn.prefill", r)
        del x, got, want
    # codes x 2^-3 with every (group, column) saturated, x on a 2^-4 grid: all
    # products and partial sums are exact in float32, so both tiles must equal
    # the plain version bit for bit (a nibble-order fault cannot)
    codes = torch.randint(-7, 8, (h, 1024), generator=g, device=dev).float()
    codes[::group] = 7.0
    q = quantize_int4(codes * 0.125, group=group)
    for m in (8, 200, 1504):
        x = (torch.randint(-128, 128, (m, h), generator=g, device=dev) * 0.0625).to(torch.bfloat16)
        got = I4.int4_matmul_kn_cuda(x, q["q4"], q["scale"], out_dtype=torch.float32)
        require(torch.equal(got, I4.int4_matmul_reference(x.float(), q["q4"], q["scale"])),
                f"K9 [{m}, {h}] differs from the plain version on power-of-two grid weights")
    print(f"[kernels] K9 on grid weights [8 | 200 | 1504, {h}] x [{h}, 1024]: both tiles equal "
          f"the plain version bit for bit", flush=True)
    del up, down, codes, q, x, got
    torch.cuda.empty_cache()
    return results


def synthetic_pages(n: int, size: int, seed: int):
    """White pages with dark text-like bars and a coloured figure, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(n):
        page = np.full((size, size, 3), 255, np.uint8)
        for _ in range(rng.integers(8, 20)):
            y, x = rng.integers(0, size - 12), rng.integers(0, size // 3)
            w = rng.integers(size // 4, size - x)
            page[y: y + rng.integers(4, 10), x: x + w] = rng.integers(0, 90)
        y, x = rng.integers(0, size // 2, size=2)
        page[y: y + size // 3, x: x + size // 3] = rng.integers(0, 256, size=3)
        pages.append(page)
    return pages


COLPALI = "vidore/colpali-v1.3"
CKPT_SHARDS = 3
# SigLIP LayerNorms and Gemma's (1 + w) RMSNorms: identity = weight 1 (0 in
# the Gemma LM), bias 0
NORM = re.compile(r"(layer_?norm\d?|\.norm)\.(weight|bias)$")


def colpali_hf_tensors(cfg):
    """(name, shape) of every tensor of a ``ColPaliForRetrieval`` checkpoint
    as transformers saves it, in its order: the SigLIP tower (without the
    pooling head PaliGemma does not use), the projector, the Gemma LM (its
    head is tied to the embedding table, so not saved) and the retrieval head."""
    v, t = cfg.vision, cfg.text
    h, inter = v.hidden_size, v.intermediate_size
    vt = "vlm.model.vision_tower.vision_model."
    out = [(vt + "embeddings.patch_embedding.weight", (h, 3, v.patch_size, v.patch_size)),
           (vt + "embeddings.patch_embedding.bias", (h,)),
           (vt + "embeddings.position_embedding.weight", (v.num_patches, h))]
    for i in range(v.num_hidden_layers):
        p = f"{vt}encoder.layers.{i}."
        out += [(p + "layer_norm1.weight", (h,)), (p + "layer_norm1.bias", (h,))]
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out += [(p + f"self_attn.{proj}.weight", (h, h)), (p + f"self_attn.{proj}.bias", (h,))]
        out += [(p + "layer_norm2.weight", (h,)), (p + "layer_norm2.bias", (h,)),
                (p + "mlp.fc1.weight", (inter, h)), (p + "mlp.fc1.bias", (inter,)),
                (p + "mlp.fc2.weight", (h, inter)), (p + "mlp.fc2.bias", (h,))]
    out += [(vt + "post_layernorm.weight", (h,)), (vt + "post_layernorm.bias", (h,)),
            ("vlm.model.multi_modal_projector.linear.weight", (v.projection_dim, h)),
            ("vlm.model.multi_modal_projector.linear.bias", (v.projection_dim,))]
    lm = "vlm.model.language_model."
    d, hd, ffn = t.hidden_size, t.head_dim, t.intermediate_size
    q, kv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    out.append((lm + "embed_tokens.weight", (t.vocab_size, d)))
    for i in range(t.num_hidden_layers):
        p = f"{lm}layers.{i}."
        out += [(p + "self_attn.q_proj.weight", (q, d)), (p + "self_attn.k_proj.weight", (kv, d)),
                (p + "self_attn.v_proj.weight", (kv, d)), (p + "self_attn.o_proj.weight", (d, q)),
                (p + "mlp.gate_proj.weight", (ffn, d)), (p + "mlp.up_proj.weight", (ffn, d)),
                (p + "mlp.down_proj.weight", (d, ffn)), (p + "input_layernorm.weight", (d,)),
                (p + "post_attention_layernorm.weight", (d,))]
    return out + [(lm + "norm.weight", (d,)), ("embedding_proj_layer.weight", (cfg.embedding_dim, d)),
                  ("embedding_proj_layer.bias", (cfg.embedding_dim,))]


def colpali_norm(name: str):
    """The identity value of a ColPali norm tensor (1 for a LayerNorm weight,
    0 for its bias and for Gemma's RMSNorm weight, which scales by 1 + w),
    None for any other tensor."""
    m = NORM.search(name)
    if not m:
        return None
    return 1.0 if m.group(2) == "weight" and ".language_model." not in name else 0.0


def write_colpali_checkpoint(torch, cfg, path: str, seed: int, shards: int = CKPT_SHARDS,
                             device: str = "cuda") -> dict:
    """A bf16 checkpoint of ``cfg`` in the HF layout (``colpali_hf_tensors``)
    through :func:`write_checkpoint`, its norms at their identity."""
    return write_checkpoint(torch, colpali_hf_tensors(cfg), path, seed, shards, device,
                            norm=colpali_norm)


def write_checkpoint(torch, tensors, path: str, seed: int, shards: int, device: str,
                     norm) -> dict:
    """``tensors`` (name, shape) in bf16, written into ``path`` as ``shards``
    safetensors files by a minimal writer of the format (8-byte header
    length, JSON header padded to 8 bytes, raw bytes). A tensor for which
    ``norm(name)`` gives a value is filled with it; every other is
    N(0, fan_in^-0.5), fan_in the product of the dims after the first (a
    1-D tensor's own length), drawn on ``device`` from ``seed``. -> bytes,
    files, seconds."""
    import os

    sizes = [2 * math.prod(shape) for _, shape in tensors]
    total = sum(sizes)
    free = shutil.disk_usage(path).free
    require(free > total + 2**30, f"writing the {total / 1e9:.2f} GB checkpoint needs that much "
                                  f"and 1 GiB more free under {path}; {free / 1e9:.2f} GB are")
    groups = [[] for _ in range(shards)]
    done = 0
    for i, ((name, shape), size) in enumerate(zip(tensors, sizes)):
        groups[min(shards - 1, done * shards // total)].append((i, name, shape))
        done += size
    t0 = time.perf_counter()
    files = []
    for k, group in enumerate(groups):
        header, off = {}, 0
        for _, name, shape in group:
            n = 2 * math.prod(shape)
            header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [off, off + n]}
            off += n
        header["__metadata__"] = {"format": "pt"}
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        files.append(os.path.join(path, f"model-{k + 1:05d}-of-{shards:05d}.safetensors"))
        with open(files[-1], "wb") as f:
            f.write(len(raw).to_bytes(8, "little") + raw)
            for i, name, shape in group:
                ident = norm(name)
                if ident is not None:
                    t = torch.full(shape, ident, dtype=torch.bfloat16)
                else:
                    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
                    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
                    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
                    t = t.mul_(float(fan_in) ** -0.5).to(torch.bfloat16).cpu()
                f.write(t.view(torch.uint8).numpy())
    return dict(path=path, bytes=sum(os.path.getsize(f) for f in files), files=len(files),
                write_s=time.perf_counter() - t0)


def check_loaded_leaves(torch, model, cfg, path: str):
    """Eleven parameters across the tower, the projector, the LM and the head
    must equal the file's tensors after the converter's transposes. -> their
    names."""
    from multimodal_colpali_tpu_torch.models import hf_import
    from multimodal_colpali_tpu_torch.models.convert import params_from_flax

    state = params_from_flax(hf_import.colpali_params_from_hf(
        hf_import.load_state_dict(path), cfg), cfg)
    lv, lt = cfg.vision.num_hidden_layers - 1, cfg.text.num_hidden_layers - 1
    names = ["vision_tower.patch_embedding.weight", "vision_tower.position_embedding",
             "vision_tower.layers.0.self_attn.q_proj.weight",
             f"vision_tower.layers.{lv}.mlp.fc2.bias", "vision_tower.post_layernorm.weight",
             "multi_modal_projector.weight", "embed.embed_tokens",
             "language_model.layers.0.self_attn.k_proj.weight",
             f"language_model.layers.{lt}.mlp.down_proj.weight", "language_model.norm.weight",
             "embedding_proj_layer.weight"]
    params = dict(model.named_parameters())
    for name in names:
        got = params[name].detach().cpu()
        require(torch.equal(got, state[name].to(got.dtype)),
                f"{name} on the card differs from the checkpoint's tensor")
    return names


class PeakRss:
    """The growth of this process's resident memory over a ``with`` block:
    its RSS sampled every 2 ms by a thread (``/proc/self/statm``), the peak
    less the RSS at entry, in bytes."""

    @staticmethod
    def rss() -> int:
        import os

        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading

        self.base = self.peak = self.rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, self.rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())
        self.growth = self.peak - self.base


def kernel_wrappers():
    """Each kernel's wrapper, whose ``.launches`` counts its launches."""
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA
    from multimodal_colpali_tpu_torch.ops import preprocess as PP
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    return {"maxsim": M.maxsim_scores_cuda, "attention": A.fused_attention_cuda,
            "normalize": PP.normalize_images_cuda, "maxsim_int8": M.maxsim_scores_int8_cuda,
            "vit_layer": FL.fused_vit_layer_cuda, "attn_block": FL.fused_vit_attention_block_cuda,
            "mlp_block": FL.fused_mlp_block_cuda, "gemm": FL.fused_gemm_cuda,
            "ln_stats": FL.ln_stats_cuda, "paged_attention": PA.paged_attention_cuda,
            "paged_attention_int8": PA.paged_attention_int8_cuda,
            "int8_matmul_kn": IM.int8_matmul_kn_cuda, "int8_matmul_nk": IM.int8_matmul_nk_cuda,
            "window_attention": WA.window_attention_cuda, "int4_matmul_kn": I4.int4_matmul_kn_cuda}


# the per-path counters of a wrapper beside its ``.launches``: K1's, K4's, K2's
# and K7's tensor-core and CUDA-core paths, K8a's and K9's decode and prefill
# tiles, the K5 GEMM's wgmma and CUDA-core paths and its four roles, K6's ring,
# WMMA and CUDA-core kernels
PATHS = {"maxsim": ("tensor_core", "cuda_core"), "maxsim_int8": ("tensor_core", "cuda_core"),
         "gemm": ("wgmma", "cuda_core", "qkv", "out_proj", "fc1", "fc2"),
         "attention": ("tensor_core", "cuda_core"), "int8_matmul_kn": ("decode", "prefill"),
         "int4_matmul_kn": ("decode", "prefill"),
         "paged_attention": ("tensor_core", "cuda_core"),
         "paged_attention_int8": ("tensor_core", "cuda_core"),
         "window_attention": ("ring", "wmma", "cuda_core")}


def reset_counts(wrappers) -> None:
    for name, fn in wrappers.items():
        fn.launches = 0
        for path in PATHS.get(name, ()):
            setattr(fn, f"{path}_launches", 0)


def read_counts(wrappers) -> dict:
    """Each wrapper's launches since ``reset_counts``, and its paths' as
    ``"<name>.<path>"``."""
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, paths in PATHS.items():
        for path in paths:
            counts[f"{name}.{path}"] = getattr(wrappers[name], f"{path}_launches")
    return counts


def page_files(pages, directory: str):
    """One file a page under ``directory``, its bytes unique to the page
    (a header naming it, then the first row of its pixels): the ``img_link``
    ``format_msgs`` base64-encodes. -> the paths, in page order."""
    out = []
    for i, page in enumerate(pages):
        path = Path(directory) / f"page{i:03d}.bin"
        path.write_bytes(f"page {i}\n".encode() + page[0].tobytes())
        out.append(str(path))
    return out


def phase_retrieval(torch, name: str, seed: int, card: str, tag: str, device_preprocess: bool,
                    path, absent, link_dir: str, checkpoint=None):
    """A retriever at full width through colpali_qdrant, retrieve_colpali,
    prompt_prep_query(type="colpali") and score_results (phases 3 and 6): the
    kernels in ``path`` must run, those in ``absent`` must not. Each page's
    ``img_link`` is a file under ``link_dir``. ``checkpoint``
    (``write_colpali_checkpoint``'s result) is loaded instead of a random
    init. -> (launches, the pages retrieved for the first query)."""
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.store import VectorClient

    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, PeakRss() as host:
        warnings.simplefilter("always")
        retr = load_retriever(name, device="cuda", dtype=torch.bfloat16, seed=seed,
                              device_preprocess=device_preprocess,
                              checkpoint_dir=checkpoint and checkpoint["path"])
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in retr.model.parameters())
    cfg = retr.model.cfg
    if checkpoint:
        require(not any("random init" in str(w.message) for w in caught),
                f"{name}: the checkpoint at {checkpoint['path']} was not loaded")
        leaves = check_loaded_leaves(torch, retr.model, cfg, checkpoint["path"])
        print(f"[{tag}] {name}: wrote a bf16 HF checkpoint of {checkpoint['bytes'] / 1e9:.2f} GB "
              f"in {checkpoint['files']} safetensors files in {checkpoint['write_s']:.1f} s; "
              f"load_retriever(checkpoint_dir=) {init_s:.2f} s = "
              f"{checkpoint['bytes'] / 1e9 / init_s:.2f} GB/s | host peak RSS growth "
              f"{host.growth / 1e9:.2f} GB | "
              f"device {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | "
              f"{len(leaves)} leaves equal the file's | {card}", flush=True)
    size = getattr(cfg, "image_size", None) or cfg.vision.image_size
    pages = synthetic_pages(N_PAGES, size, seed)
    retr.embed_images(pages[:EMBED_BATCH], batch_size=EMBED_BATCH)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    embs = retr.embed_images(pages, batch_size=EMBED_BATCH)
    embed_s = time.perf_counter() - t0
    dim = retr.model.cfg.embedding_dim
    require(len(embs) == N_PAGES, "embed_images: wrong number of pages")
    for e in embs:
        require(e.ndim == 2 and e.shape[1] == dim, f"embedding shape {e.shape}")
        require(bool(np.isfinite(e).all()), "non-finite embedding")
        require(bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                "valid tokens are not unit-norm")

    client = VectorClient(device="cuda")
    api.ensure_colpali_collection(client, "smoke", vector_size=dim)
    users = ["alice", "bob"]
    half = N_PAGES // 2
    forwards = 2 * N_PAGES // EMBED_BATCH       # page batches embedded: the run above, indexing
    links = page_files(pages, link_dir)
    for u, user in enumerate(users):
        dataset = [{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                    "img_link": links[i]} for i in range(u * half, (u + 1) * half)]
        api.colpali_qdrant(dataset, [], [], retr, retr.processor, client, "smoke",
                           batch_size=EMBED_BATCH, username=user)
    require(client.count("smoke").count == N_PAGES, "collection does not hold every page")

    api.retrieve_colpali("warm-up query", retr.processor, retr, client, "", "smoke", TOP_K)
    query_ms, retrieved = [], []
    for qtext in QUERIES:
        t0 = time.perf_counter()
        res = api.retrieve_colpali(qtext, retr.processor, retr, client, "", "smoke", TOP_K)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        retrieved.append([(p.payload["document_name"], p.payload["page_no"]) for p in res.points])
    # prompt_prep_query's colpali mode: one image prompt a page retrieve_colpali finds
    want_links = [p.payload["img_link"] for p in api.retrieve_colpali(
        QUERIES[0], retr.processor, retr, client, "", "smoke", TOP_K).points]
    built = api.prompt_prep_query(QUERIES[0], "Q: {query}", client, "", "smoke", None, TOP_K,
                                  type="colpali", cp_model=retr, cp_processor=retr.processor)
    by_bytes = {Path(f).read_bytes(): f for f in links}
    got_links = [by_bytes[base64.b64decode(p[0]["content"][1]["image_url"]["url"].split(",")[1])]
                 for p in built["q_prompts"]]
    require(got_links == want_links and len(got_links) == TOP_K,
            f"prompt_prep_query(type='colpali') built prompts of {got_links}, "
            f"retrieve_colpali found {want_links}")
    filtered = api.retrieve_colpali(QUERIES[0], retr.processor, retr, client, users[0],
                                    "smoke", TOP_K)
    require(len(filtered.points) == TOP_K, "filtered query returned too few pages")
    require(all(p.payload["username"] == users[0] for p in filtered.points),
            "filtered query returned another user's page")

    dataset = [{"embedding": embs[i], "doc_id": i // 4, "page_id": i % 4,
                "file_name": f"doc{i // 4}.pdf"} for i in range(N_PAGES)]
    images_per_pdf = {f"doc{j}.pdf": pages[4 * j: 4 * j + 4] for j in range(N_PAGES // 4)}
    scored = api.score_results(QUERIES, retr.processor, retr, dataset, images_per_pdf, TOP_K)
    full = retr.processor.score_multi_vector(retr.embed_queries(QUERIES), embs, device="cuda")
    index = {(f"doc{i // 4}.pdf", i % 4): i for i in range(N_PAGES)}
    exact = True
    for qi, (ret, sc) in enumerate(zip(retrieved, scored)):
        want = [(r["file_name"], r["page_id"]) for r in sc]
        require(len(ret) == TOP_K, f"query {qi}: retrieve_colpali returned {len(ret)} pages")
        exact &= ret == want
        for a, b in zip(ret, want):
            sa, sb = full[qi, index[a]], full[qi, index[b]]
            require(abs(sa - sb) <= 0.1 + 1e-2 * abs(sb),
                    f"query {qi}: retrieve_colpali {ret} vs score_results {want} beyond ties")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    require(all(launches[k] > 0 for k in path), f"a kernel of the {name} path did not run: "
            f"{launches}")
    require(all(launches[k] == 0 for k in absent),
            f"{name} launched a kernel off its path ({', '.join(absent)}): {launches}")
    if "window_attention" in path:
        blocks = sum(cfg.vision.depths)       # spatial blocks: one launch each a forward
        require(launches["window_attention.ring"] == launches["window_attention"]
                == blocks * forwards,
                f"{name}: {launches['window_attention']} window-attention launches "
                f"({launches['window_attention.ring']} on the ring kernel), not {blocks} a "
                f"forward over {forwards} page batches, all on the ring kernel")
    pages_s = N_PAGES / embed_s
    print(f"[{tag}] {name} {n_params / 1e9:.3f}B params bf16 (init {init_s:.1f} s), "
          f"{N_PAGES} pages x {embs[0].shape[0]} tokens x {dim}: embed {pages_s:.2f} pages/s, "
          f"retrieve_colpali {np.mean(query_ms):.1f} ms/query (mean of "
          f"{', '.join(f'{t:.1f}' for t in query_ms)}), "
          f"filter ok, prompt_prep_query(colpali) built prompts of those pages, "
          f"top-{TOP_K} vs score_results "
          f"{'identical' if exact else 'equal up to ties'}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    del retr, client
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [index[p] for p in retrieved[0]]


def _key(p):
    return p.payload["document_name"], p.payload["page_no"]


def phase_colsmol(torch, seed: int, card: str):
    """Full-width ColSmol-256M through colpali_qdrant and query_points on the
    exact, int8, pooled and on_disk store modes."""
    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.store import (
        Distance, FieldCondition, Filter, MatchValue, MultiVectorConfig,
        QuantizationSearchParams, SearchParams, VectorClient, VectorParams)

    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    retr = load_retriever("vidore/colSmol-256M", device="cuda", dtype=torch.bfloat16,
                          seed=seed, device_preprocess=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in retr.model.parameters())
    size = retr.processor.image_preprocessor.image_size
    pages = synthetic_pages(SMOL_PAGES, size, seed + 1)
    retr.embed_images(pages[:SMOL_BATCH], batch_size=SMOL_BATCH)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    embs = retr.embed_images(pages, batch_size=SMOL_BATCH)
    embed_s = time.perf_counter() - t0
    dim = retr.model.cfg.embedding_dim
    require(len(embs) == SMOL_PAGES, "ColSmol embed_images: wrong number of pages")
    for e in embs:
        require(e.ndim == 2 and e.shape[1] == dim, f"ColSmol embedding shape {e.shape}")
        require(bool(np.isfinite(e).all()), "ColSmol: non-finite embedding")
        require(bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                "ColSmol: valid tokens are not unit-norm")

    # the partial fused kernels (K5b, K5c) through the same entry point
    parts_cos = {}
    for parts in ("attn", "mlp"):
        L.set_fused_parts(parts)
        try:
            other = retr.embed_images(pages[:SMOL_BATCH], batch_size=SMOL_BATCH)
        finally:
            L.set_fused_parts("both")
        for e in other:
            require(bool(np.isfinite(e).all()) and
                    bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                    f"ColSmol with fused parts {parts!r}: bad embedding")
        parts_cos[parts] = float(np.mean([np.sum(a * b, axis=-1).mean()
                                          for a, b in zip(other, embs)]))

    users = ["alice", "bob"]
    half = SMOL_PAGES // 2
    datasets = [[{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                  "img_link": ""} for i in range(u * half, (u + 1) * half)]
                for u in range(len(users))]

    def index(client, name):
        for user, dataset in zip(users, datasets):
            api.colpali_qdrant(dataset, [], [], retr, retr.processor, client, name,
                               batch_size=SMOL_BATCH, username=user)
        require(client.count(name).count == SMOL_PAGES, f"{name}: collection is incomplete")

    client = VectorClient(device="cuda")
    api.ensure_colpali_collection(client, "exact", vector_size=dim)
    api.ensure_colpali_collection(client, "int8", vector_size=dim, quantized=True)
    client.create_collection("pooled", VectorParams(size=dim, distance=Distance.COSINE,
                                                    multivector_config=MultiVectorConfig()),
                             quantized=True, prefilter="pooled")
    for name in ("exact", "int8", "pooled"):
        index(client, name)
    (REPO / "build").mkdir(exist_ok=True)
    disk_dir = Path(tempfile.mkdtemp(prefix="smoke-on-disk-", dir=REPO / "build"))
    try:
        disk = VectorClient(path=str(disk_dir), device="cuda")
        api.ensure_colpali_collection(disk, "on_disk", vector_size=dim, on_disk=True)
        index(disk, "on_disk")
        disk.save()
        disk = VectorClient(path=str(disk_dir), device="cuda")  # reopened: a memory map
        require(disk._get("on_disk").on_disk, "the reopened collection is not on_disk")
        colls = {"exact": client, "int8": client, "pooled": client, "on_disk": disk}
        vecs = {n: c._get(n)._vectors for n, c in colls.items()}
        require(all(np.array_equal(np.asarray(v), vecs["exact"]) for v in vecs.values()),
                "ColSmol: the four indexing runs embedded the pages differently")

        q_embs = retr.embed_queries(QUERIES)
        every = SearchParams(quantization=QuantizationSearchParams(
            ignore=False, oversampling=SMOL_PAGES / TOP_K))
        default = SearchParams(quantization=QuantizationSearchParams(ignore=False))
        alice = Filter(must=[FieldCondition(key="username", match=MatchValue(value="alice"))])
        full = {}   # exact scores of every page, per query
        recall = {n: [] for n in ("int8", "pooled", "on_disk")}
        mode_ms = {n: [] for n in colls}
        for qi, q in enumerate(q_embs):
            res = {}
            for name, c in colls.items():
                t0 = time.perf_counter()
                res[name] = c.query_points(name, q, limit=TOP_K, search_params=every).points
                mode_ms[name].append((time.perf_counter() - t0) * 1e3)
                flt = c.query_points(name, q, limit=TOP_K, query_filter=alice,
                                     search_params=every).points
                require(len(flt) == TOP_K and all(p.payload["username"] == "alice"
                                                  for p in flt),
                        f"{name}: the username filter returned another user's page")
            full[qi] = {_key(p): p.score for p in client.query_points(
                "exact", q, limit=SMOL_PAGES).points}
            ref = [(_key(p), p.score) for p in res["exact"]]
            require([(_key(p), p.score) for p in res["int8"]] == ref,
                     f"query {qi}: int8 with every page a candidate is not the exact scan "
                     f"bit for bit")
            require([(_key(p), p.score) for p in res["on_disk"]] ==
                    [(_key(p), p.score) for p in res["pooled"]],
                    f"query {qi}: on_disk differs from the device-resident pooled search")
            for a, b in zip(res["pooled"], res["exact"]):
                sa, sb = full[qi][_key(a)], full[qi][_key(b)]
                require(abs(sa - sb) <= 1e-2 * abs(sb) + 1e-2,
                        f"query {qi}: pooled top-{TOP_K} differs from exact beyond near-ties")
            want = {_key(p) for p in res["exact"]}
            for name in recall:
                got = client if name != "on_disk" else disk
                top = got.query_points(name, q, limit=TOP_K, search_params=default).points
                recall[name].append(len(want & {_key(p) for p in top}) / TOP_K)
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)

    api.retrieve_colpali("warm-up query", retr.processor, retr, client, "", "exact", TOP_K)
    query_ms = []
    for qtext in QUERIES:
        t0 = time.perf_counter()
        api.retrieve_colpali(qtext, retr.processor, retr, client, "", "exact", TOP_K)
        query_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    path = ("maxsim", "maxsim.tensor_core", "attention", "attention.tensor_core", "normalize",
            "maxsim_int8", "maxsim_int8.tensor_core", "vit_layer", "attn_block", "mlp_block",
            "gemm", "gemm.wgmma", "ln_stats")
    require(all(launches[k] > 0 for k in path),
            f"a kernel of the ColSmol path did not run: {launches}")
    # every bf16 GEMM of the tower on gemm_wgmma: 4 a K5a (12 a batch), 2 a
    # K5b or K5c, each role once a block it belongs to, none on the CUDA cores
    vit, att, mlpb = launches["vit_layer"], launches["attn_block"], launches["mlp_block"]
    layers = retr.model.cfg.vision.num_hidden_layers
    require(vit % layers == 0 and launches["gemm.wgmma"] == 4 * vit + 2 * att + 2 * mlpb
            and launches["gemm"] == launches["gemm.wgmma"] and launches["gemm.cuda_core"] == 0
            and launches["gemm.qkv"] == launches["gemm.out_proj"] == vit + att
            and launches["gemm.fc1"] == launches["gemm.fc2"] == vit + mlpb
            and launches["ln_stats"] == 2 * vit + att + mlpb,
            f"ColSmol's GEMMs did not all take gemm_wgmma as K5a-c chain them: {launches}")
    print(f"[colsmol] vidore/colSmol-256M {n_params / 1e6:.1f}M params bf16 (init {init_s:.1f} s), "
          f"{SMOL_PAGES} pages x {embs[0].shape[0]} tokens x {dim}: embed "
          f"{SMOL_PAGES / embed_s:.2f} pages/s (batches of {SMOL_BATCH}), retrieve_colpali "
          f"{np.mean(query_ms):.1f} ms/query (mean of {', '.join(f'{t:.1f}' for t in query_ms)}), "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}", flush=True)
    print(f"[colsmol] every page a candidate: int8 = exact bit for bit, on_disk = pooled bit "
          f"for bit, pooled = exact up to near-ties, filter ok | query_points ms (mean): "
          + ", ".join(f"{n} {np.mean(t):.2f}" for n, t in mode_ms.items())
          + f" | recall@{TOP_K} vs exact at oversampling 2.0: "
          + ", ".join(f"{n} {np.mean(r):.3f}" for n, r in recall.items())
          + f" | fused parts attn/mlp vs both: mean token cosine {parts_cos['attn']:.5f}/"
          f"{parts_cos['mlp']:.5f}", flush=True)
    print(f"[colsmol] launches {json.dumps(launches)}", flush=True)
    return launches


GEN_MODEL = "google/gemma-3-27b-it"
GEN = dict(slots=4, max_seq_len=2048, chunk=8, page=16, max_tokens=32)
PROMPT_TOKENS = (320, 1100, 700, 1300, 1550)   # the chat prompt's tokens, roughly
MCQ_FORMAT = {"type": "json_schema", "json_schema": {"name": "mcq", "schema": {
    "type": "object", "properties": {"answer": {"type": "string",
                                                "enum": ["A", "B", "C", "D"]}}}}}
WORDS = ("selectin", "glycan", "ligand", "binding", "affinity", "sialyl", "Lewis", "fucose",
         "leukocyte", "endothelial", "adhesion", "rolling", "receptor", "domain", "lectin",
         "calcium", "epitope", "antibody", "assay", "kinetics", "dissociation", "constant",
         "measured", "surface", "plasmon", "resonance", "table", "figure", "supplementary",
         "protein", "mutant", "wild-type", "structure", "crystal", "residue", "pocket")


def mcq_prompt(rng, n_tokens: int) -> str:
    """A RAG-style multiple-choice prompt of about ``n_tokens`` byte tokens:
    retrieved context passages, a question and four options."""
    tail = ("\nQuestion: Which statement about selectin binding is supported by the "
            "context?\nOptions: A) calcium is required B) fucose is dispensable "
            "C) affinity is nanomolar D) rolling needs no shear\nAnswer with the letter.")
    parts, n, doc = [], 0, 0
    budget = n_tokens - len(tail) - 20
    while n < budget:
        doc += 1
        sent = " ".join(rng.choice(WORDS, size=int(rng.integers(12, 30))))
        piece = f"[Doc {doc}, page {int(rng.integers(1, 20))}] {sent.capitalize()}. "
        parts.append(piece)
        n += len(piece)
    return "Context:\n" + "".join(parts)[:budget] + tail


def chat(base_url: str, body: dict):
    """POST a chat completion; -> (status, reply text, finish_reason, seconds).
    A streamed reply is read event by event and its deltas joined."""
    import urllib.request

    req = urllib.request.Request(base_url + "/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        if not body.get("stream"):
            out = json.loads(resp.read())["choices"][0]
            return resp.status, out["message"]["content"], out["finish_reason"], \
                time.perf_counter() - t0
        text, finish = [], None
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            ev = json.loads(line[6:])
            require("error" not in ev, f"stream error event {ev}")
            text.append(ev["choices"][0]["delta"].get("content", ""))
            finish = ev["choices"][0]["finish_reason"] or finish
        return resp.status, "".join(text), finish, time.perf_counter() - t0


def first_divergence(engine, ids, got, want):
    """None when the streams agree; else (step, gap of the engine's top two
    logits there)."""
    import numpy as np

    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            break
    else:
        require(len(got) == len(want), f"stream lengths differ: {len(got)} vs {len(want)}")
        return None
    top2 = np.sort(engine.next_token_logits([ids + want[:i]])[0])[-2:]
    return i, float(top2[1] - top2[0])


def serve_run(torch, engine, tok, tag: str, kv_dtype: str, requests, card: str):
    """One run of phase 5: the paged batcher and the HTTP server over
    ``engine``; every request sent at once. Returns the launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_colpali_tpu_torch.generation import (
        GenerationServer, PagedContinuousBatcher, render_chat_prompt)

    wrappers = kernel_wrappers()
    bat = PagedContinuousBatcher(engine, batch_slots=GEN["slots"],
                                 max_seq_len=GEN["max_seq_len"], chunk=GEN["chunk"],
                                 page_size=GEN["page"], kv_dtype=kv_dtype,
                                 eos_id=tok.eos_id).serve()
    srv = GenerationServer(bat, tok, model_name=GEN_MODEL, host="127.0.0.1", port=0).start()
    try:
        status, _, _, _ = chat(srv.base_url, {"messages": [{"role": "user", "content": "warm"}],
                                              "max_tokens": 2})         # warm-up
        require(status == 200, f"[{tag}] warm-up request failed")
        torch.cuda.synchronize()
        bat.decode_s, bat.decode_steps, bat.decode_tokens, bat.ttft_s = 0.0, 0, 0, []
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as ex:
            outs = list(ex.map(lambda r: chat(srv.base_url, r[1]), requests))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
        bat.shutdown()
    stats = dict(decode_s=bat.decode_s, steps=bat.decode_steps, tokens=bat.decode_tokens,
                 ttft=list(bat.ttft_s), preemptions=bat.preemptions)
    del srv, bat   # the server holds the batcher (and its pools) until it goes
    gc.collect()
    torch.cuda.empty_cache()

    greedy_notes, sampled = [], []
    for (kind, body), (status, text, finish, secs) in zip(requests, outs):
        require(status == 200 and text, f"[{tag}] {kind} request failed: {status} {text!r}")
        if kind == "mcq":
            require(json.loads(text).get("answer") in ("A", "B", "C", "D"),
                    f"[{tag}] the MCQ reply is not a choice: {text!r}")
            continue
        got = [int(t) for t in text.split()]
        require(len(got) == GEN["max_tokens"] and finish == "length",
                f"[{tag}] {kind}: {len(got)} tokens, finish {finish}")
        if kind == "sampled":
            sampled.append(got)
            continue
        ids = tok.encode(render_chat_prompt(body["messages"]), add_special_tokens=True)
        want = engine.generate([ids], max_new_tokens=GEN["max_tokens"], eos_id=tok.eos_id)[0]
        div = first_divergence(engine, ids, got, want)
        if div is None:
            greedy_notes.append(f"{len(ids)} tok: identical")
        else:
            require(div[1] <= 0.05, f"[{tag}] a {len(ids)}-token greedy stream first differs "
                                    f"from the engine's at step {div[0]}, where the top two "
                                    f"logits are {div[1]:.4f} apart (> 0.05)")
            greedy_notes.append(f"{len(ids)} tok: first differs at step {div[0]} (top-2 gap "
                                f"{div[1]:.4f})")
    if sampled:
        require(len(sampled) == 2 and sampled[0] == sampled[1],
                f"[{tag}] the two sampled replies with one seed differ")
    tok_s = stats["tokens"] / stats["decode_s"] if stats["decode_s"] else 0.0
    step_ms = 1e3 * stats["decode_s"] / max(stats["steps"], 1)
    print(f"[gen-{tag}] {len(requests)} concurrent requests in {wall:.1f} s | decode "
          f"{tok_s:.1f} tokens/s over {GEN['slots']} slots, {step_ms:.1f} ms per decode step "
          f"(one output token of every active slot), "
          f"{1e3 / tok_s if tok_s else float('nan'):.1f} ms per output token | TTFT ms "
          f"{[round(1e3 * t) for t in stats['ttft']]} | peak {peak:.1f} GiB | preemptions "
          f"{stats['preemptions']} | greedy vs engine.generate: {'; '.join(greedy_notes)} | "
          f"{'sampled pair equal, MCQ reply a choice | ' if sampled else ''}{card}", flush=True)
    print(f"[gen-{tag}] launches {json.dumps(launches)}", flush=True)
    return launches


def phase_generation(torch, seed: int, card: str):
    """Full-width gemma-3-27b served over HTTP: runs (a), (b), (c) and (d)."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import GemmaDecodeEngine, ModuloTokenizer
    from multimodal_colpali_tpu_torch.models.registry import load_gemma3_lm, tree_leaves

    rng = np.random.default_rng(seed)
    p = [mcq_prompt(rng, n) for n in PROMPT_TOKENS]

    def msg(text, **kw):
        return {"messages": [{"role": "user", "content": text}],
                "max_tokens": GEN["max_tokens"], **kw}

    sampling = dict(temperature=0.7, top_p=0.9, seed=seed + 7)
    greedy = [("greedy", msg(p[0])), ("greedy", msg(p[1], stream=True)), ("greedy", msg(p[4]))]
    requests = greedy[:2] + [("mcq", msg(p[2], response_format=MCQ_FORMAT)),
                             ("sampled", msg(p[3], **sampling)),
                             ("sampled", msg(p[3], **sampling)), greedy[2]]
    bf16 = torch.bfloat16

    t0 = time.perf_counter()
    cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed)
    engine = GemmaDecodeEngine(cfg, params, dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(engine.params))
    tok = ModuloTokenizer(cfg.vocab_size)
    print(f"[gen] {GEN_MODEL} {n_params / 1e9:.2f}B params bf16 on the card in "
          f"{time.perf_counter() - t0:.1f} s ({torch.cuda.memory_allocated() / 2**30:.1f} GiB); "
          f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, {cfg.num_attention_heads}"
          f"/{cfg.num_key_value_heads} heads of {cfg.head_dim}, window {cfg.sliding_window}; "
          f"prompts "
          f"{[len(tok.encode(x)) for x in p]} tokens", flush=True)
    runs = {"a": serve_run(torch, engine, tok, "a", "native", requests, card)}
    require(runs["a"]["paged_attention.tensor_core"] > 0,
            f"(a) never launched K7a's tensor-core path: {runs['a']}")
    runs["b"] = serve_run(torch, engine, tok, "b", "int8", greedy, card)
    require(runs["b"]["paged_attention_int8.tensor_core"] > 0,
            f"(b) never launched K7b's tensor-core path: {runs['b']}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed,
                                    weight_dtype="int8")
    engine = GemmaDecodeEngine(cfg, params, dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    print(f"[gen] {GEN_MODEL} int8 weights made leaf by leaf in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)", flush=True)
    runs["c"] = serve_run(torch, engine, tok, "c", "native", greedy, card)
    require(runs["c"]["int8_matmul_kn.decode"] > 0 and runs["c"]["int8_matmul_kn.prefill"] > 0
            and runs["c"]["int8_matmul_nk"] > 0,
            f"(c) never launched both of K8a's tiles and K8b: {runs['c']}")
    require(runs["c"]["paged_attention.tensor_core"] > 0,
            f"(c) never launched K7a's tensor-core path: {runs['c']}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed,
                                    weight_dtype="int4")
    engine = GemmaDecodeEngine(cfg, params, dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    require(engine.weight_dtype == "int4", "the int4 tree was not detected as int4")
    print(f"[gen] {GEN_MODEL} int4 weights (group 256) made leaf by leaf in "
          f"{time.perf_counter() - t0:.1f} s ({torch.cuda.memory_allocated() / 2**30:.1f} GiB)",
          flush=True)
    runs["d"] = serve_run(torch, engine, tok, "d", "native", greedy, card)
    require(runs["d"]["int4_matmul_kn.decode"] > 0 and runs["d"]["int4_matmul_kn.prefill"] > 0
            and runs["d"]["int8_matmul_nk"] > 0,
            f"(d) never launched both of K9's tiles and K8b: {runs['d']}")
    require(runs["d"]["int8_matmul_kn"] == 0, f"(d) ran a projection as int8: {runs['d']}")
    require(runs["d"]["paged_attention.tensor_core"] > 0,
            f"(d) never launched K7a's tensor-core path: {runs['d']}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


IMG = dict(slots=4, max_seq_len=6144, chunk=8, page=16, max_tokens=32)
QUESTION = "Which binding constant do these pages report for sialyl Lewis x? Answer briefly."


def check_greedy(tag: str, key: str, got, want, gap_at) -> str:
    """A greedy reply against the isolated engine's: identical, or first
    different where the engine's top two logits are within 0.05
    (``gap_at(step)``)."""
    require(len(got) == IMG["max_tokens"], f"[{tag}] {key}: {len(got)} tokens")
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        require(len(got) == len(want), f"[{tag}] {key}: {len(got)} tokens, the isolated "
                                       f"engine's {len(want)}")
        return f"{key}: identical"
    gap = gap_at(i)
    require(gap <= 0.05, f"[{tag}] {key} first differs from the isolated engine at step {i}, "
                         f"where its top two logits are {gap:.4f} apart (> 0.05)")
    return f"{key}: first differs at step {i} (top-2 gap {gap:.4f})"


def prefill_split(torch, mm, ids, pix):
    """One image prompt's prefill through ``mm`` split by CUDA events into
    the tower, the projector and the LM prefill (the merge into the text
    embeddings, every layer, the head's logits); the second of two runs.
    -> ms (tower, projector, LM prefill)."""
    from multimodal_colpali_tpu_torch.generation.engine import left_pad

    eng = mm.lm
    s = -(-len(ids) // 16) * 16
    tid, mask = (eng._tensor(a) for a in left_pad([ids], s, 0))
    pix = mm._pixels(pix)[None]
    with torch.inference_mode():
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            kc, vc = eng._caches(1, s)
            ev[0].record()
            vis = mm._tower(pix)
            ev[1].record()
            img = mm._project(vis, 1)
            ev[2].record()
            hidden, _, _ = mm._prefill_embeds(tid, mask, mm._merge(tid, img), kc, vc)
            eng._logits(eng.params, hidden[:, -1])
            ev[3].record()
            torch.cuda.synchronize()
            del kc, vc, vis, img, hidden
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def image_run(torch, mm, tok, tag: str, pix, text_prompts, card: str, conf=None, asks=None):
    """One run of phase 7 or 8: greedy image requests (``asks``: (key, image
    count, question), the first ``n`` images of ``pix`` each) and two text
    requests submitted at once to the paged batcher with ``mm`` (``conf``
    sizes it, its ``marks`` go to ``build_mm_prompt``), then an MCQ scored
    over all of ``pix`` through ``next_token_logits``, and the largest image
    prompt's prefill split into tower, projector and LM. With the batcher's
    ``prefix_caching`` on in ``conf``, the requests after the first over the
    same images must prefill only their tails. Returns the launch counts."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import PagedContinuousBatcher
    from multimodal_colpali_tpu_torch.generation.scheduler import _pixel_digest

    conf = conf or IMG
    prefix_caching = conf.get("prefix_caching", False)
    asks = asks or [("1 page", 1, QUESTION), (f"{TOP_K} pages", TOP_K, QUESTION)]
    wrappers = kernel_wrappers()
    eng = mm.lm
    newline = tok.encode("\n")

    marks = conf.get("marks", {})

    def prompt(question, n):
        return mm.build_mm_prompt(tok.encode(question), bos_id=tok.bos_id, newline_ids=newline,
                                  n_images=n, **marks)

    img = {key: (prompt(q, n), pix[:n]) for key, n, q in asks}
    txt = {f"text {i}": tok.encode(p, add_special_tokens=True) for i, p in enumerate(text_prompts)}
    bat = PagedContinuousBatcher(eng, batch_slots=conf["slots"], max_seq_len=conf["max_seq_len"],
                                 chunk=conf["chunk"], page_size=conf["page"], mm_engine=mm,
                                 eos_id=tok.eos_id, prefix_caching=prefix_caching)
    # warm-up at the requests' shapes on other pixels, one character of each
    # question and the first text token changed, so neither the prefill
    # cache nor the prefix pages serve the requests later
    warm_pix = pix * 0.5
    bat.generate([prompt(q.replace("?", "!"), n) for _, n, q in asks]
                 + [ids[:1] + [ids[1] + 1] + ids[2:] for ids in txt.values()],
                 max_new_tokens=2, pixel_values=[warm_pix[:n] for _, n, _ in asks]
                 + [None] * len(txt))
    torch.cuda.synchronize()
    # the image requests' tail-only prefills, each with the pages it reused:
    # the batcher's own counters also count text prompts that share a page
    image_tails = []
    tail_prefill = bat._prefix_prefill

    def spy(prompt_eff, ctx, mm_request):
        out = tail_prefill(prompt_eff, ctx, mm_request)
        if mm_request and out is not None:
            image_tails.append(out[4][1])
        return out

    bat._prefix_prefill = spy
    bat.decode_s, bat.decode_steps, bat.decode_tokens = 0.0, 0, 0
    bat.prefix_cache_hits = bat.prefix_prefill_hits = 0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    first, futs = {}, {}
    t0 = time.perf_counter()
    for key, (ids, p) in [*img.items(), *((k, (v, None)) for k, v in txt.items())]:
        futs[key] = bat.submit(ids, max_new_tokens=conf["max_tokens"], pixel_values=p,
                               on_token=lambda _, k=key, t=time.perf_counter(): first.setdefault(
                                   k, time.perf_counter() - t))
    bat.drain()
    wall = time.perf_counter() - t0
    got = {k: f.result(timeout=60) for k, f in futs.items()}
    scaffold = asks[-1][2] + '\n{"answer": "'
    n_scaffold = len(tok.encode(scaffold))
    firsts = [tok.encode(scaffold + c)[n_scaffold] for c in "ABCD"]
    mcq_ids = mm.build_mm_prompt(tok.encode(scaffold), bos_id=tok.bos_id, n_images=len(pix),
                                 **marks)
    t1 = time.perf_counter()
    logits = mm.next_token_logits([mcq_ids], pix[None])[0]
    mcq_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode = (bat.decode_tokens, bat.decode_s, bat.decode_steps)
    hits = (bat.prefix_cache_hits, bat.prefix_prefill_hits)
    del bat
    gc.collect()
    torch.cuda.empty_cache()
    require(logits.shape == (mm.cfg.text.vocab_size,) and bool(np.isfinite(logits).all()),
            f"[{tag}] MCQ logits: shape {logits.shape}, not all finite")
    answer = "ABCD"[int(np.argmax(logits[firsts]))]
    if prefix_caching:
        shared = sum(n == len(pix) for _, n, _ in asks) - 1
        # a tail-only image prefill holds no image token in its tail: every
        # image span came from the cached pages
        require(len(image_tails) >= shared,
                f"[{tag}] {len(image_tails)} image requests prefilled only their tails, not "
                f"the {shared} that share the first's images")

    # the isolated engines, each step's top-two logit gap recorded as it decodes
    notes = []
    eng.record_top2 = True
    for key, (ids, p) in [*img.items(), *((k, (v, None)) for k, v in txt.items())]:
        want = (eng.generate([ids], max_new_tokens=conf["max_tokens"], eos_id=tok.eos_id)
                if p is None else mm.generate([ids], p[None], max_new_tokens=conf["max_tokens"],
                                              eos_id=tok.eos_id))[0]
        gaps = eng.top2_gaps[0]
        notes.append(check_greedy(tag, key, got[key], want, lambda i, g=gaps: float(g[i])))
    eng.record_top2 = False
    key, (ids, p) = max(img.items(), key=lambda kv: len(kv[1][1]))
    split = prefill_split(torch, mm, ids, p)
    t1 = time.perf_counter()
    _pixel_digest(torch.from_numpy(np.ascontiguousarray(p)))
    digest_ms = (time.perf_counter() - t1) * 1e3
    tokens, secs, steps = decode
    print(f"[{tag}] {eng.weight_dtype} LM weights: image requests "
          f"({', '.join(f'{k}: {len(v[0])} tokens' for k, v in img.items())}) and text requests "
          f"({', '.join(f'{len(v)} tokens' for v in txt.values())}) submitted at once, in that "
          f"order, served in {wall:.2f} s | TTFT ms "
          f"{ {k: round(v * 1e3, 1) for k, v in first.items()} } | decode "
          f"{tokens / secs:.1f} tokens/s over {conf['slots']} slots, "
          f"{1e3 * secs / max(steps, 1):.1f} ms a step | MCQ over {len(pix)} images: {answer!r} "
          f"in {mcq_ms:.1f} ms | peak {peak:.1f} GiB | prefix pages reused {hits[0]}, tail-only "
          f"prefills {hits[1]}, of them image requests' {len(image_tails)} (pages reused "
          f"{image_tails}) | greedy vs the isolated engines: {'; '.join(notes)} | {card}",
          flush=True)
    print(f"[{tag}] {key} prefill by CUDA events: tower {split[0]:.1f} ms, projector "
          f"{split[1]:.2f} ms, LM prefill ({len(ids)} tokens) {split[2]:.1f} ms; pixel digest "
          f"{digest_ms:.1f} ms on the host | {card}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    return launches


def phase_images(torch, seed: int, card: str, checkpoint: dict, top_pages):
    """Phase 7: image-context serving at full width on the weights of
    phase 3's checkpoint (reloaded): ``PaliGemmaEngine`` on the retriever's
    own tower and projector, its LM the text engine's, in the paged batcher;
    run (a) with bf16 LM weights, run (b) with int8."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        GemmaDecodeEngine, ModuloTokenizer, PaliGemmaEngine)
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_state_dict

    bf16 = torch.bfloat16
    retr = load_retriever(COLPALI, device="cuda", dtype=bf16, checkpoint_dir=checkpoint["path"])
    cfg = retr.model.cfg
    pages = synthetic_pages(N_PAGES, cfg.vision.image_size, seed)
    pix = retr.processor.image_preprocessor([pages[i] for i in top_pages])   # [5, H, W, 3]
    tok = ModuloTokenizer(cfg.text.vocab_size)
    rng = np.random.default_rng(seed + 11)
    text_prompts = [mcq_prompt(rng, 300), mcq_prompt(rng, 700)]
    runs = {}
    for tag, weight_dtype in (("a", "native"), ("b", "int8")):
        engine = GemmaDecodeEngine(cfg.text, engine_params_from_state_dict(retr.model.state_dict()),
                                   dtype=bf16, weight_dtype=weight_dtype, device="cuda")
        mm = PaliGemmaEngine(retr.model, lm=engine)
        runs[tag] = image_run(torch, mm, tok, f"img-{tag}", pix, text_prompts, card)
        del mm, engine
        gc.collect()
        torch.cuda.empty_cache()
    del retr
    gc.collect()
    torch.cuda.empty_cache()
    for tag in ("a", "b"):
        require(runs[tag]["attention.tensor_core"] > 0 and runs[tag]["paged_attention.tensor_core"] > 0,
                f"(img-{tag}) never launched K2's or K7a's tensor-core path: {runs[tag]}")
    require(runs["b"]["int8_matmul_kn.decode"] > 0 and runs["b"]["int8_matmul_kn.prefill"] > 0
            and runs["b"]["int8_matmul_nk"] > 0,
            f"(img-b) never launched both of K8a's tiles and K8b: {runs['b']}")
    require(runs["a"]["int8_matmul_kn"] == 0, f"(img-a) ran a projection as int8: {runs['a']}")
    return runs


# Gemma-3's <start_of_image> and <end_of_image> around each image, as its chat
# template writes them: each image is then its own span of 256 tokens, which
# prefix caching requires (adjacent spans without them form one run)
G3_IMG = dict(slots=4, max_seq_len=2048, chunk=8, page=16, max_tokens=32, prefix_caching=True,
              marks=dict(boi_id=255_999, eoi_id=256_000))
# both questions over the 5 images open with one preamble, so the page after
# the image spans is shared too and the second question's tail holds no image
PREAMBLE = "Answer from the page images above, citing the page. "
G3_ASKS = [("1 image", 1, PREAMBLE + QUESTION),
           (f"{TOP_K} images", TOP_K, PREAMBLE + QUESTION),
           (f"{TOP_K} images, 2nd question", TOP_K,
            PREAMBLE + "Which figure shows the rolling velocity under shear? Answer briefly.")]


def phase_gemma3_images(torch, seed: int, card: str):
    """Phase 8: ``google/gemma-3-27b-it`` with images at full width and depth
    (random weights from ``seed`` through ``load_gemma3_mm``): the text
    engine and a ``Gemma3MMEngine`` on its LM in the paged batcher with
    prefix caching; run (a) bf16 LM weights, run (b) int8 made leaf by leaf
    on the card."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        Gemma3MMEngine, GemmaDecodeEngine, ModuloTokenizer)
    from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor
    from multimodal_colpali_tpu_torch.models.registry import load_gemma3_mm, tree_leaves

    bf16 = torch.bfloat16
    rng = np.random.default_rng(seed + 13)
    text_prompts = [mcq_prompt(rng, 300), mcq_prompt(rng, 700)]
    runs = {}
    for tag, weight_dtype in (("a", "native"), ("b", "int8")):
        t0 = time.perf_counter()
        cfg, params, _ = load_gemma3_mm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed,
                                        weight_dtype=weight_dtype)
        tower, projector = params.pop("vision_tower"), params.pop("multi_modal_projector")
        engine = GemmaDecodeEngine(cfg.text, params, dtype=bf16, device="cuda")
        mm = Gemma3MMEngine(cfg, tower, projector, lm=engine)
        torch.cuda.synchronize()
        require(engine.weight_dtype == weight_dtype,
                f"[g3-{tag}] the LM is {engine.weight_dtype}, not {weight_dtype}")
        n_lm = sum(t.numel() for _, t in tree_leaves(engine.params))
        n_tower = sum(p.numel() for p in tower.parameters())
        # 896 x 896 pages: the preprocessor normalizes them without a resize
        pages = synthetic_pages(TOP_K, cfg.vision.image_size, seed)
        pix = ImagePreprocessor(cfg.vision.image_size)(pages)              # [5, 896, 896, 3]
        tok = ModuloTokenizer(cfg.text.vocab_size)
        print(f"[g3-{tag}] {GEN_MODEL} with images: LM {weight_dtype} ({n_lm / 1e9:.2f}B "
              f"elements), SigLIP-So400m {n_tower / 1e9:.3f}B params bf16 at "
              f"{cfg.vision.image_size} px ({cfg.vision.num_patches} patches, "
              f"{cfg.mm_tokens_per_image} soft tokens an image) made in "
              f"{time.perf_counter() - t0:.1f} s ({torch.cuda.memory_allocated() / 2**30:.1f} "
              f"GiB)", flush=True)
        runs[tag] = image_run(torch, mm, tok, f"g3-{tag}", pix, text_prompts, card,
                              conf=G3_IMG, asks=G3_ASKS)
        del mm, engine, tower, projector, params
        gc.collect()
        torch.cuda.empty_cache()
    for tag in ("a", "b"):
        require(runs[tag]["attention.tensor_core"] > 0
                and runs[tag]["paged_attention.tensor_core"] > 0,
                f"(g3-{tag}) never launched K2's or K7a's tensor-core path: {runs[tag]}")
    require(runs["b"]["int8_matmul_kn.decode"] > 0 and runs["b"]["int8_matmul_kn.prefill"] > 0
            and runs["b"]["int8_matmul_nk"] > 0,
            f"(g3-b) never launched both of K8a's tiles and K8b: {runs['b']}")
    require(runs["a"]["int8_matmul_kn"] == 0, f"(g3-a) ran a projection as int8: {runs['a']}")
    return runs


BGE = "BAAI/bge-base-en-v1.5"
# 4,096 chunks of 64-512 tokens (the chunker's range, max 512) embedded in
# batches of 64; a corpus of 100,000 chunks (~500 papers of ~200) over 4
# users; the Glycan benchmark's 120 questions, top-5
DENSE = dict(chunks=4096, batch=64, corpus=100_000, users=4, questions=120, top_k=5,
             f32_rows=64, self_rows=16, roundtrip=5, near_tie=1e-5)


def bert_hf_tensors(cfg):
    """(name, shape) of every tensor of a ``BertModel`` checkpoint (bge-base)
    as transformers saves it, in its order, the pooler included."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    out = [("embeddings.word_embeddings.weight", (cfg.vocab_size, h)),
           ("embeddings.position_embeddings.weight", (cfg.max_position_embeddings, h)),
           ("embeddings.token_type_embeddings.weight", (cfg.type_vocab_size, h)),
           ("embeddings.LayerNorm.weight", (h,)), ("embeddings.LayerNorm.bias", (h,))]
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            out += [(p + f"attention.self.{name}.weight", (h, h)),
                    (p + f"attention.self.{name}.bias", (h,))]
        out += [(p + "attention.output.dense.weight", (h, h)),
                (p + "attention.output.dense.bias", (h,)),
                (p + "attention.output.LayerNorm.weight", (h,)),
                (p + "attention.output.LayerNorm.bias", (h,)),
                (p + "intermediate.dense.weight", (inter, h)),
                (p + "intermediate.dense.bias", (inter,)),
                (p + "output.dense.weight", (h, inter)), (p + "output.dense.bias", (h,)),
                (p + "output.LayerNorm.weight", (h,)), (p + "output.LayerNorm.bias", (h,))]
    return out + [("pooler.dense.weight", (h, h)), ("pooler.dense.bias", (h,))]


def bert_norm(name: str):
    """A BERT LayerNorm at its identity (weight 1, bias 0); None otherwise."""
    if name.endswith("LayerNorm.weight"):
        return 1.0
    return 0.0 if name.endswith("LayerNorm.bias") else None


def check_bert_leaves(torch, model, cfg, path: str):
    """Parameters across the embeddings and the first and last layers must
    equal the file's tensors after the converter's transposes. -> their names."""
    from multimodal_colpali_tpu_torch.models import hf_import
    from multimodal_colpali_tpu_torch.models.convert import params_from_flax

    state = params_from_flax(hf_import.bert_params_from_hf(
        hf_import.load_state_dict(path), cfg), cfg)
    last = cfg.num_hidden_layers - 1
    names = ["word_embeddings", "position_embeddings", "token_type_embeddings",
             "embeddings_layernorm.weight", "layers.0.attention.query.weight",
             "layers.0.attention.key.bias", f"layers.{last}.intermediate.weight",
             f"layers.{last}.output_layernorm.bias"]
    params = dict(model.named_parameters())
    for name in names:
        got = params[name].detach().cpu()
        require(torch.equal(got, state[name].to(got.dtype)),
                f"{name} on the card differs from the checkpoint's tensor")
    return names


def synthetic_chunks(n: int, seed: int, lo: int = 64, hi: int = 512):
    """``n`` texts of ``lo``-``hi`` tokens (uniform, [CLS] and [SEP] counted),
    words drawn from a synthetic vocabulary of 20,000 lowercase words: the
    hash tokenizer gives one token a word."""
    import numpy as np

    rng = np.random.default_rng(seed + 9)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, int(k))) for k in rng.integers(3, 11, size=20_000)]
    lens = rng.integers(lo, hi + 1, size=n) - 2
    return [" ".join(vocab[j] for j in rng.integers(0, len(vocab), size=int(m))) for m in lens]


class TimedEmbeddings:
    """An embeddings object's surface that times its calls: the seconds of
    the last ``embed_documents`` and its vectors (the embedding pass inside
    ``qdrant_process``), and the seconds ``embed_query`` adds up (the
    embedding share of a similarity search)."""

    def __init__(self, emb):
        self.emb, self.query_s, self.documents_s, self.documents = emb, 0.0, 0.0, None

    def embed_documents(self, texts, batch_size: int = 64):
        t0 = time.perf_counter()
        self.documents = self.emb.embed_documents(texts, batch_size=batch_size)
        self.documents_s = time.perf_counter() - t0
        return self.documents

    def embed_query(self, text: str):
        t0 = time.perf_counter()
        v = self.emb.embed_query(text)
        self.query_s += time.perf_counter() - t0
        return v


def phase_dense(torch, seed: int, card: str, work: str) -> dict:
    """Phase 9: the dense RAG modes at full width, bf16 (``BAAI/bge-base-en-v1.5``
    = BERT-base; random values from ``seed`` in a bf16 HF checkpoint under
    ``work``). -> the kernel launches of (b)-(e): none may rise."""
    import os
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.documents import Document, make_metadata
    from multimodal_colpali_tpu_torch.models.bert import BertEncoder
    from multimodal_colpali_tpu_torch.models.configs import BertConfig
    from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings
    from multimodal_colpali_tpu_torch.store import (
        FieldCondition, Filter, MatchValue, PointStruct, VectorClient)

    d = DENSE
    cfg = BertConfig.bge_base()
    wrappers = kernel_wrappers()
    t_phase = time.perf_counter()
    # (a) a bf16 HF checkpoint, loaded through checkpoint_dir=
    ckpt_dir = os.path.join(work, "bge-ckpt")
    os.makedirs(ckpt_dir)
    ckpt = write_checkpoint(torch, bert_hf_tensors(cfg), ckpt_dir, seed, 1, "cuda",
                            norm=bert_norm)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        emb = BgeEmbeddings(BGE, cfg=cfg, checkpoint_dir=ckpt_dir, device="cuda")
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(not any("random init" in str(w.message) for w in caught),
            f"{BGE}: the checkpoint at {ckpt_dir} was not loaded")
    leaves = check_bert_leaves(torch, emb.model, cfg, ckpt_dir)
    shutil.rmtree(ckpt_dir)
    n_params = sum(p.numel() for p in emb.model.parameters())
    print(f"[dense] {BGE}: a bf16 HF checkpoint of {ckpt['bytes'] / 1e6:.1f} MB written in "
          f"{ckpt['write_s']:.2f} s, BgeEmbeddings(checkpoint_dir=) {load_s:.2f} s, "
          f"{n_params / 1e6:.1f}M parameters, {len(leaves)} leaves equal the file's | {card}",
          flush=True)

    # (b) + (c): the chunks through qdrant_process, whose one embed_documents
    # pass (batch 64) is timed and gated
    users = [f"user{u}" for u in range(d["users"])]
    img_dir = Path(work) / "figures"
    img_dir.mkdir()
    figures = []
    for k in range(8):
        figures.append(str(img_dir / f"fig{k}.bin"))
        Path(figures[-1]).write_bytes(f"figure {k}\n".encode() * 64)
    chunks = synthetic_chunks(d["chunks"], seed)
    docs = []
    for i, text in enumerate(chunks):
        is_fig = i % 8 == 7        # a VLM summary of a figure (multimodal RAG)
        meta = make_metadata(f"paper{i // 200:03d}.pdf", f"doc{i}", type=(
            "image" if is_fig else "text"), page_no=1 + i % 12,
            img_link=figures[i // 8 % 8] if is_fig else "")
        meta["username"] = users[i % d["users"]]
        docs.append(Document(text, meta))
    n_tokens = sum(len(c.split()) + 2 for c in chunks)   # a token a word, [CLS], [SEP]
    emb.embed_documents(chunks[: d["batch"]], batch_size=d["batch"])   # warm-up
    store_dir = os.path.join(work, "vector-db")
    client = VectorClient(store_dir, device="cuda")
    coll = "text_vd"
    timed = TimedEmbeddings(emb)
    tokenize, tokenize_s = emb._tokenize, [0.0]

    def timed_tokenize(texts, bucket=32):     # the host's share of embed_documents
        t0 = time.perf_counter()
        out = tokenize(texts, bucket)
        tokenize_s[0] += time.perf_counter() - t0
        return out

    emb._tokenize = timed_tokenize
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    api.qdrant_process(docs, client, coll, cfg.hidden_size, timed)
    process_s = time.perf_counter() - t0
    del emb._tokenize
    embed_s = timed.documents_s
    vecs = np.asarray(timed.documents, np.float32)
    require(vecs.shape == (d["chunks"], cfg.hidden_size) and bool(np.isfinite(vecs).all()),
            f"embed_documents gave {vecs.shape}")
    norms = np.linalg.norm(vecs, axis=-1)
    require(bool(np.all(np.abs(norms - 1) <= 1e-3)),
            f"embeddings not unit-norm: {norms.min()}..{norms.max()}")
    rows = np.arange(d["f32_rows"]) * (d["chunks"] // d["f32_rows"])
    f32 = BertEncoder(cfg, device="cuda", dtype=torch.float32)
    f32.load_state_dict(emb.model.state_dict())
    ids, mask = emb._tokenize([chunks[i] for i in rows])
    with torch.inference_mode():
        ref = f32(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu().numpy()
    del f32
    cos = np.sum(ref * vecs[rows], -1) / np.linalg.norm(ref, axis=-1) / norms[rows]
    require(cos.min() >= 0.995, f"bf16 embeddings against float32: cosine {cos.min():.5f}")
    print(f"[dense] embed_documents: {d['chunks']} chunks of 64-512 tokens (batch "
          f"{d['batch']}) in {embed_s:.2f} s = {d['chunks'] / embed_s:.1f} chunks/s, "
          f"{n_tokens / embed_s:.0f} tokens/s unpadded (host tokenization "
          f"{tokenize_s[0]:.2f} s of it); unit norms within "
          f"{np.abs(norms - 1).max():.2e}; cosine with a float32 forward on {len(rows)} "
          f"chunks >= {cos.min():.6f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB | {card}", flush=True)

    # (c) synthetic unit vectors fill the collection to 100,000 chunks
    rng = np.random.default_rng(seed + 11)
    n_syn = d["corpus"] - d["chunks"]
    syn = rng.standard_normal((n_syn, cfg.hidden_size), dtype=np.float32)
    syn /= np.linalg.norm(syn, axis=-1, keepdims=True)
    points = [PointStruct(id=f"syn-{j}", vector=syn[j], payload={
        "page_content": f"synthetic chunk {j}",
        "metadata": {"document_name": f"paper{(d['chunks'] + j) // 200:03d}.pdf",
                     "type": "text", "img_link": "", "page_no": 1 + j % 12,
                     "username": users[(d["chunks"] + j) % d["users"]]}})
        for j in range(n_syn)]
    t0 = time.perf_counter()
    client.upsert(coll, points)
    upsert_s = time.perf_counter() - t0
    del points, syn
    require(client.count(coll).count == d["corpus"], "the collection does not hold every chunk")

    # (d) 120 questions: embed, search without and with the filter, the prompt functions
    store = api.TpuVectorStore(client, coll, timed)
    questions = [" ".join(c.split()[:12]) + "?" for c in synthetic_chunks(
        d["questions"], seed + 1, lo=14, hi=14)]
    store.similarity_search_with_score(questions[0], d["top_k"])       # warm-up: the upload
    dense_store = client._get(coll)
    corpus = dense_store._device_cache
    host_vecs = torch.from_numpy(dense_store._vectors).cuda().to(torch.bfloat16).float()
    device_mb = corpus.numel() * corpus.element_size() / 1e6
    embed_ms, plain_ms, filt_ms, prep_ms, first = [], [], [], [], []
    near_ties = 0
    for qi, question in enumerate(questions):
        user = users[qi % d["users"]]
        flt = Filter(must=[FieldCondition(key="metadata.username", match=MatchValue(value=user))])
        t0 = time.perf_counter()
        qv = emb.embed_query(question)
        t1 = time.perf_counter()
        res = client.query_points(coll, query=qv, limit=d["top_k"])
        t2 = time.perf_counter()
        timed.query_s = 0.0
        hits = store.similarity_search_with_score(question, d["top_k"], filter=flt)
        t3 = time.perf_counter()
        built = api.prompt_prep_query(question, "Answer from the context: {query}", client,
                                      user, coll, emb, d["top_k"], type="mm_RAG")
        t4 = time.perf_counter()
        embed_ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
        filt_ms.append((t3 - t2 - timed.query_s) * 1e3)
        prep_ms.append((t4 - t3) * 1e3)
        first.append(res)
        # gate 3: the top-5 of a float32 product of the same bf16 corpus, stable order
        q = np.asarray(qv, np.float32)
        q = torch.from_numpy(q / max(np.linalg.norm(q), 1e-12)).cuda().to(torch.bfloat16)
        ref = host_vecs @ q.float()
        order = torch.argsort(-ref, stable=True)[: d["top_k"]].tolist()
        got = [dense_store._id_to_idx[p.id] for p in res.points]
        for a, b in zip(got, order):
            if a != b:
                require(abs(float(ref[a]) - float(ref[b])) < d["near_tie"],
                        f"question {qi}: top-{d['top_k']} {got} against the float32 "
                        f"product's {order} beyond near-ties")
                near_ties += 1
        # gate 5: the filter
        require(len(hits) == d["top_k"] and all(doc.metadata["username"] == user
                                               for doc, _ in hits),
                f"question {qi}: the filtered search returned another user's chunk")
        require([doc.page_content for doc, _ in built["context"]]
                == [doc.page_content for doc, _ in hits] and
                len(built["q_prompts"]) == d["top_k"],
                f"question {qi}: prompt_prep_query(type='mm_RAG') differs from the search")
        for (doc, _), msgs in zip(hits, built["q_prompts"]):
            kinds = [part["type"] for part in msgs[0]["content"]]
            require(kinds == (["text", "image_url"] if doc.metadata["type"] == "image"
                              else ["text"]), f"question {qi}: prompt parts {kinds}")
    none = api.prompt_prep_query(questions[0], "{query}", client, users[0], coll, emb,
                                 d["top_k"], type="")
    require(none["context"] == [] and none["q_prompts"] == [], "type='' built a context")
    # gate 4: chunks queried by their own text come back first
    self_rows = np.arange(d["self_rows"]) * (d["chunks"] // d["self_rows"]) + 3
    worst = 0.0
    for i in self_rows:
        top = store.similarity_search_with_score(chunks[i], d["top_k"])
        require(top[0][0].page_content == chunks[i] and abs(top[0][1] - 1) <= 5e-2,
                f"chunk {i} queried by its own text: first {top[0][0].page_content[:40]!r} "
                f"at {top[0][1]:.4f}")
        worst = max(worst, abs(top[0][1] - 1))
    print(f"[dense] corpus {d['corpus']} chunks x {cfg.hidden_size} ({d['users']} users): "
          f"qdrant_process of {d['chunks']} chunks {process_s:.2f} s (its embedding pass "
          f"included), "
          f"upsert of {n_syn} vectors {upsert_s:.2f} s, {device_mb:.1f} MB on the card "
          f"(bf16); {d['questions']} questions, ms a query: embed {np.mean(embed_ms):.2f} "
          f"(median {np.median(embed_ms):.2f}), search without a filter "
          f"{np.mean(plain_ms):.2f} (median {np.median(plain_ms):.2f}), search with the "
          f"filter {np.mean(filt_ms):.2f} (median {np.median(filt_ms):.2f}), "
          f"prompt_prep_query(mm_RAG) {np.mean(prep_ms):.2f}; top-{d['top_k']} equal to the "
          f"float32 product ({near_ties} near-ties), filter ok, {len(self_rows)} chunks "
          f"first by their own text within {worst:.2e} of 1; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}", flush=True)

    # (e) the round trip through the files
    t0 = time.perf_counter()
    client.save()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = VectorClient(store_dir, device="cuda")
    load_s = time.perf_counter() - t0
    for qi in range(d["roundtrip"]):
        qv = emb.embed_query(questions[qi])
        res = again.query_points(coll, query=qv, limit=d["top_k"])
        require([(p.id, p.score) for p in res.points]
                == [(p.id, p.score) for p in first[qi].points],
                f"question {qi}: the reloaded store gives other ids or scores")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    require(not any(launches.values()), f"the dense path launched a port kernel: {launches}")
    size = sum(f.stat().st_size for f in Path(store_dir).rglob("*") if f.is_file())
    print(f"[dense] VectorClient(path).save() {save_s:.2f} s ({size / 1e6:.1f} MB), "
          f"VectorClient(path) {load_s:.2f} s; {d['roundtrip']} queries bit-identical after "
          f"the reload; no port kernel launched; phase 9 took "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    del client, again, emb, store, corpus, host_vecs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (REPO / PACKAGE / "__init__.py").is_file():
        print(f"FAIL: {PACKAGE}/ not found beside {Path(__file__).name}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from multimodal_colpali_tpu_torch import _build

    card = phase_device(torch, _build)
    kernels = phase_kernels(torch, args.seed)
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS

    (REPO / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="colpali-ckpt-", dir=REPO / "build")
    work = tempfile.mkdtemp(prefix="smoke-", dir=REPO / "build")
    try:
        ckpt = write_colpali_checkpoint(torch, RETRIEVER_CONFIGS[COLPALI](), ckpt_dir, args.seed)
        colpali, top_pages = phase_retrieval(
            torch, COLPALI, args.seed, card, "main", device_preprocess=True,
            path=("maxsim", "maxsim.tensor_core", "attention", "attention.tensor_core",
                  "normalize"),
            absent=("vit_layer",),   # SigLIP-So400m is not fused
            link_dir=tempfile.mkdtemp(dir=work), checkpoint=ckpt)
        images = phase_images(torch, args.seed, card, ckpt, top_pages)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        colsmol = phase_colsmol(torch, args.seed, card)
        gen = phase_generation(torch, args.seed, card)
        g3 = phase_gemma3_images(torch, args.seed, card)
        # ColFlor normalizes on the host; its BART attention has a mask, so no K2
        colflor, _ = phase_retrieval(torch, "ahmed-masry/ColFlor", args.seed, card, "colflor",
                                     device_preprocess=False,
                                     path=("window_attention", "window_attention.ring",
                                           "maxsim", "maxsim.tensor_core"),
                                     absent=("attention", "normalize"),
                                     link_dir=tempfile.mkdtemp(dir=work))
        dense = phase_dense(torch, args.seed, card, work)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)

    jax_ops = "multimodal_colpali_tpu/ops"
    meta = {
        "maxsim": ("cuda", f"{PACKAGE}/csrc/maxsim.cu", f"{jax_ops}/maxsim.py:196"),
        "attention": ("cuda", f"{PACKAGE}/csrc/attention.cu", f"{jax_ops}/attention.py:135"),
        "normalize": ("cuda", f"{PACKAGE}/csrc/normalize.cu", f"{jax_ops}/preprocess.py:54"),
        "maxsim_int8": ("cuda", f"{PACKAGE}/csrc/maxsim.cu", f"{jax_ops}/maxsim.py:307"),
        "vit_layer": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:367"),
        "attn_block": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu",
                       f"{jax_ops}/fused_layer.py:247"),
        "mlp_block": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:440"),
        # the GEMMs and the statistics pre-pass K5a-c are made of, each a row
        "gemm.qkv": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:247"),
        "gemm.out_proj": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu",
                          f"{jax_ops}/fused_layer.py:247"),
        "gemm.fc1": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:440"),
        "gemm.fc2": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:440"),
        "ln_stats": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:367"),
        "paged_attention": ("cuda", f"{PACKAGE}/csrc/paged_attention.cu",
                            f"{jax_ops}/paged_attention.py:196"),
        "paged_attention_int8": ("cuda", f"{PACKAGE}/csrc/paged_attention.cu",
                                 f"{jax_ops}/paged_attention.py:350"),
        "int8_matmul_kn": ("cuda", f"{PACKAGE}/csrc/int8_matmul.cu",
                           f"{jax_ops}/int8_matmul.py:145"),
        "int8_matmul_nk": ("cuda", f"{PACKAGE}/csrc/int8_matmul.cu",
                           f"{jax_ops}/int8_matmul.py:179"),
        "window_attention": ("cuda", f"{PACKAGE}/csrc/window_attention.cu",
                             f"{jax_ops}/window_attention.py:79"),
        "int4_matmul_kn": ("cuda", f"{PACKAGE}/csrc/int4_matmul.cu",
                           f"{jax_ops}/int4_matmul.py:134"),
    }
    # each kernel's launches on the main paths that run it; K8a and K9 a row a
    # tile (the decode tile's under the wrapper's name)
    meta["int8_matmul_kn.prefill"] = meta["int8_matmul_kn"]
    meta["int4_matmul_kn.prefill"] = meta["int4_matmul_kn"]
    tile_of = {"int8_matmul_kn": "int8_matmul_kn.decode", "int4_matmul_kn": "int4_matmul_kn.decode"}
    # K2 at the Gemma-3 tower's shape: its launches are phase 8's
    meta["attention.gemma3_tower"] = meta["attention"]
    paths = [colpali, images["a"], images["b"], colsmol, gen["a"], gen["b"], gen["c"],
             gen["d"], colflor, g3["a"], g3["b"], dense]
    launches = {name: sum(p[tile_of.get(name, name)] for p in paths) for name in meta
                if name != "attention.gemma3_tower"}
    launches["attention.gemma3_tower"] = g3["a"]["attention"] + g3["b"]["attention"]
    rows = [dict(name=name, route=route, source=src, replaces=rep, launches=launches[name],
                 **kernels[name])
            for name, (route, src, rep) in meta.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
