#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``. It
drives ``multimodal_colpali_tpu_torch`` (never JAX) and prints one line per
phase; any failure exits non-zero.

1. Device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the build time of the kernels (nvcc for K1 and K2 into
   ``build/kernels``, Triton for K3).
2. Kernels against their plain PyTorch versions, both on the card, at the
   retrieval path's shapes, with the time of each.
3. The main path at full width: ``vidore/colpali-v1.3`` with random bf16
   weights from ``--seed`` embeds 16 synthetic 448x448 pages, indexes them
   with ``colpali_qdrant``, answers 4 queries with ``retrieve_colpali`` (one
   also under a ``username`` filter) and scores them with ``score_results``.
   Every kernel's launch counter must rise during this phase.

The line before the last is a JSON object with each kernel's launches in
phase 3, its error against the plain version and both times; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "multimodal_colpali_tpu_torch"

K1 = dict(b=4, nq=32, dim=128, p=4096, nt=1030)
K2 = dict(b=8, s=1024, h=16, d=72)
K3 = dict(b=8, size=448)
N_PAGES, EMBED_BATCH, TOP_K = 16, 8, 5
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
    from multimodal_colpali_tpu_torch.ops.preprocess import normalize_images_triton

    t0 = time.perf_counter()
    normalize_images_triton(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="cuda"))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | build: nvcc "
          f"{nvcc_s:.1f} s ({', '.join(sorted(libs))}), triton K3 {triton_s:.1f} s | "
          f"ptxas: {ptxas_summary(libs)}", flush=True)
    return card


def phase_kernels(torch, seed: int):
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops import preprocess as PP
    from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    # K1: MaxSim at [4, 32, 128] x [4096, 1030, 128] bf16, ragged pages, some empty
    c = K1
    q = F.normalize(torch.randn(c["b"], c["nq"], c["dim"], generator=g, device=dev), dim=-1)
    q = q.to(torch.bfloat16)
    d = torch.empty(c["p"], c["nt"], c["dim"], dtype=torch.bfloat16, device=dev)
    for s in range(0, c["p"], 512):
        part = torch.randn(min(512, c["p"] - s), c["nt"], c["dim"], generator=g, device=dev)
        d[s: s + 512] = F.normalize(part, dim=-1).to(torch.bfloat16)
    q_lens = torch.tensor([c["nq"], 20, 1, c["nq"]], dtype=torch.int32, device=dev)
    d_lens = torch.randint(1, c["nt"] + 1, (c["p"],), generator=g, device=dev, dtype=torch.int32)
    d_lens[::97] = 0
    got = M.maxsim_scores_cuda(q, d, q_lens, d_lens)
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
    odd = c["p"] - 3  # odd page count
    got_odd = M.maxsim_scores_cuda(q, d[:odd], q_lens, d_lens[:odd])
    require(torch.allclose(got_odd, got[:, :odd]), "K1: odd page count differs")
    k_ms, p_ms = timed_pair(torch, lambda: M.maxsim_scores_cuda(q, d, q_lens, d_lens),
                            lambda: M.maxsim_scores_reference(q, d, q_lens, d_lens), iters=5)
    results["maxsim"] = dict(max_abs_err=k1_err, ms=k_ms, plain_ms=p_ms)
    top_same = bool((ki == pi).all())
    print(f"[kernels] K1 maxsim {list(q.shape)}x{list(d.shape)} bf16: max|err| {k1_err:.3g} "
          f"(rtol 1e-3), empty pages exact, top-5 {'identical' if top_same else 'equal up to ties'}"
          f" | kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
    del d, got, want
    torch.cuda.empty_cache()

    # K2: SigLIP-So400m self-attention [8, 1024, 16, 72] bf16, plus masked cases
    c = K2
    shape = (c["b"], c["s"], c["h"], c["d"])
    qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    scale = c["d"] ** -0.5
    got = A.fused_attention_cuda(*qkv, scale=scale)
    want = A.attention_reference(*qkv, scale=scale)
    k2_err = float((got.float() - want.float()).abs().max())
    require(k2_err <= 2e-2, f"K2: max|err| {k2_err} > 2e-2")
    small = (2, 40, 3, 24)
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        sq = [torch.randn(small, generator=g, device=dev).to(dtype) for _ in range(3)]
        lens = torch.tensor([40, 17], dtype=torch.int32, device=dev)
        valid = torch.rand(2, 40, generator=g, device=dev) > 0.4
        valid[1] = False  # a row with every key masked: uniform weights
        for kw in (dict(kv_lens=lens), dict(kv_valid=valid), dict(causal=True),
                   dict(kv_lens=lens, kv_valid=valid, causal=True)):
            a = A.fused_attention_cuda(*sq, scale=0.2, **kw)
            b = A.attention_reference(*sq, scale=0.2, **kw)
            err = float((a.float() - b.float()).abs().max())
            require(err <= atol, f"K2 small case {dtype} {sorted(kw)}: max|err| {err} > {atol}")
    k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(*qkv, scale=scale),
                            lambda: A.attention_reference(*qkv, scale=scale), iters=10)
    results["attention"] = dict(max_abs_err=k2_err, ms=k_ms, plain_ms=p_ms)
    print(f"[kernels] K2 attention {list(shape)} bf16: max|err| {k2_err:.3g} (atol 2e-2); "
          f"kv_lens/kv_valid/causal cases pass | kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms",
          flush=True)
    del qkv, got, want
    torch.cuda.empty_cache()

    # K3: uint8 -> bf16 normalize at [8, 448, 448, 3]
    c = K3
    x = torch.randint(0, 256, (c["b"], c["size"], c["size"], 3), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    mean, std = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    got = PP.normalize_images_triton(x, mean, std)
    want = PP.normalize_images_reference(x, mean, std)
    ulps = int(bf16_ulps(torch, got, want).max())
    require(ulps <= 1, f"K3: {ulps} bf16 ulps from the plain version (limit 1)")
    k3_err = float((got.float() - want.float()).abs().max())
    k_ms, p_ms = timed_pair(torch, lambda: PP.normalize_images_triton(x, mean, std),
                            lambda: PP.normalize_images_reference(x, mean, std), iters=20)
    results["normalize"] = dict(max_abs_err=k3_err, ms=k_ms, plain_ms=p_ms)
    print(f"[kernels] K3 normalize {list(x.shape)} u8->bf16: max {ulps} ulp, max|err| "
          f"{k3_err:.3g} | kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
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


def phase_main_path(torch, seed: int, card: str):
    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops import preprocess as PP
    from multimodal_colpali_tpu_torch.store import VectorClient

    wrappers = {"maxsim": M.maxsim_scores_cuda, "attention": A.fused_attention_cuda,
                "normalize": PP.normalize_images_triton}
    t0 = time.perf_counter()
    retr = load_retriever("vidore/colpali-v1.3", device="cuda", dtype=torch.bfloat16,
                          seed=seed, device_preprocess=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in retr.model.parameters())
    pages = synthetic_pages(N_PAGES, retr.processor.image_preprocessor.image_size, seed)
    retr.embed_images(pages[:EMBED_BATCH], batch_size=EMBED_BATCH)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
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
    for u, user in enumerate(users):
        dataset = [{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                    "img_link": ""} for i in range(u * half, (u + 1) * half)]
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
    launches = {k: fn.launches for k, fn in wrappers.items()}
    require(all(n > 0 for n in launches.values()), f"a kernel did not run: {launches}")
    pages_s = N_PAGES / embed_s
    print(f"[main] vidore/colpali-v1.3 {n_params / 1e9:.2f}B params bf16 (init {init_s:.1f} s), "
          f"{N_PAGES} pages x {embs[0].shape[0]} tokens x {dim}: embed {pages_s:.2f} pages/s, "
          f"retrieve_colpali {np.mean(query_ms):.1f} ms/query (mean of "
          f"{', '.join(f'{t:.1f}' for t in query_ms)}), "
          f"filter ok, top-{TOP_K} vs score_results "
          f"{'identical' if exact else 'equal up to ties'}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}", flush=True)
    print(f"[main] launches {json.dumps(launches)}", flush=True)
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
    launches = phase_main_path(torch, args.seed, card)

    meta = {
        "maxsim": ("cuda", f"{PACKAGE}/csrc/maxsim.cu", "multimodal_colpali_tpu/ops/maxsim.py:196"),
        "attention": ("cuda", f"{PACKAGE}/csrc/attention.cu",
                      "multimodal_colpali_tpu/ops/attention.py:135"),
        "normalize": ("triton", f"{PACKAGE}/ops/_normalize_triton.py",
                      "multimodal_colpali_tpu/ops/preprocess.py:54"),
    }
    rows = [dict(name=name, route=route, source=src, replaces=rep, launches=launches[name],
                 **kernels[name]) for name, (route, src, rep) in meta.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
