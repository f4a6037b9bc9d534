"""Where a retriever's embedding time goes on one NVIDIA GPU: ColSmol-256M
or ColFlor.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.breakdown [--model colsmol|colflor]
        [--seed N] [--pages 16] [--iters 5]

It loads the model at full width with random bf16 weights from ``--seed`` in
the configuration of ``chip_smoke.py`` (``vidore/colSmol-256M`` with
``device_preprocess=True``, phase 4; ``ahmed-masry/ColFlor``, which
normalizes on the host, phase 6) and times, for one batch of ``--pages``
synthetic pages at the model's size and for 4 queries, each part of the
embedding path:

- host ``process_images`` (ColSmol: the resize; ColFlor: the ImageNet
  normalization too) and ``process_queries``, host clock;
- the pixels' upload (+ K3 for ColSmol), the vision tower and the whole model
  forward, each with CUDA events; the rest of the model is the forward less
  the tower. The rest is also run alone (the forward with the tower's output
  given), with CUDA events and as the host's time to issue it with the
  device idle, beside the tower's issue time: where the rest is
  launch-bound, the forward less the tower shrinks by whatever of its
  launches the host issues while the device still runs the tower. ColSmol:
  one SigLIP layer as K5a and its halves K5b and K5c, and K5a's parts alone
  (its four GEMMs, each with its LayerNorm statistics launch where it has
  one, the statistics launch, and K2). ColFlor: the
  tower's 12 window-attention launches (K6) at their shapes, and the copies
  around them (q, k and v out of the qkv projection, the output transposed
  back);
- ``embed_images`` and a single-query forward, host clock around the call
  (both end in a device-to-host copy).

Every figure is the mean of ``--iters`` runs after one warm-up run. The
first line is the card's name and power limit as ``nvidia-smi`` prints
them; the last is one JSON object with every number, in ms unless named
otherwise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

QUERIES = ["what binds selectins", "glycan structures in biology",
           "binding affinity measurements", "supplementary data tables"]


def _device_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _host_issue_ms(torch, fn, iters: int) -> float:
    """Host clock from the call to its return, the device idle before each
    call: the host's time to issue ``fn``."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total * 1e3 / iters


def _colsmol_parts(torch, model, pix, n, it) -> dict:
    """One SigLIP layer as K5a, K5b and K5c at the batch's shape, and K5a's
    parts alone: its four GEMMs (with their LayerNorm statistics launch
    where they have one), the statistics launch, and K2."""
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    layer = model.vision_model.layers[0]
    c = layer.cfg
    h, s_, heads = c.hidden_size, c.num_patches, c.num_attention_heads
    x = torch.randn(n, s_, h, device="cuda").to(torch.bfloat16)
    eps = c.layer_norm_eps
    g1, b1, wq, bq, wk, bk, wv, bv, wo, bo = layer._attn_params()
    g2, b2, w1, bb1, w2, bb2 = layer._mlp_params()
    x2d = x.view(-1, h)
    hid = torch.randn(n * s_, c.intermediate_size, device="cuda").to(torch.bfloat16)
    q, k, v = (torch.randn(n, s_, heads, h // heads, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    gemm = FL.fused_gemm_cuda
    return {"k5a_layer": _device_ms(torch, lambda: FL.fused_vit_layer_cuda(
                x, *layer._attn_params(), *layer._mlp_params(), heads=heads, eps=eps), it),
            "k5b_attn_half": _device_ms(torch, lambda: FL.fused_vit_attention_block_cuda(
                x, *layer._attn_params(), heads=heads, eps=eps), it),
            "k5c_mlp_half": _device_ms(torch, lambda: FL.fused_mlp_block_cuda(
                x, *layer._mlp_params(), eps=eps), it),
            "k5_gemm_qkv": _device_ms(torch, lambda: gemm(
                x2d, (wq, wk, wv), (bq, bk, bv), "bias", ln=(g1, b1), eps=eps), it),
            "k5_gemm_out_proj": _device_ms(torch, lambda: gemm(
                x2d, (wo,), (bo,), "residual", resid=x2d), it),
            "k5_gemm_fc1": _device_ms(torch, lambda: gemm(
                x2d, (w1,), (bb1,), "gelu", ln=(g2, b2), eps=eps), it),
            "k5_gemm_fc2": _device_ms(torch, lambda: gemm(
                hid, (w2,), (bb2,), "residual", resid=x2d), it),
            "k5_ln_stats": _device_ms(torch, lambda: FL.ln_stats_cuda(x2d, eps), it),
            "k2_attention": _device_ms(torch, lambda: A.fused_attention_cuda(
                q, k, v, scale=(h // heads) ** -0.5), it)}


def _colflor_parts(torch, model, pix, n, it) -> dict:
    """The DaViT tower's K6 launches at their shapes: one a spatial block, on
    ``[n x windows x heads, window^2, head_dim]`` rows (windows padded); and
    the copies around each launch (``florence2.split_heads`` and
    ``merge_heads``, as ``WindowAttention.forward`` makes them)."""
    from multimodal_colpali_tpu_torch.models.florence2 import merge_heads, split_heads
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    def copies(proj, heads, out):
        return split_heads(proj, heads), merge_heads(out, heads)

    c = model.cfg.vision
    ws, side, calls = c.window_size, model.cfg.image_size, []
    for stage, depth in enumerate(c.depths):
        side //= c.patch_stride[stage]
        heads = c.num_heads[stage]
        hd = c.embed_dim[stage] // heads
        n_win = n * (-(-side // ws)) ** 2
        qkv = [torch.randn(n_win * heads, ws * ws, hd, device="cuda").to(torch.bfloat16)
               for _ in range(3)]
        proj = torch.randn(n_win, ws * ws, 3 * heads * hd, device="cuda").to(torch.bfloat16)
        calls += [(qkv, hd ** -0.5, proj, heads)] * depth
    return {"tower_k6_launches": len(calls),
            "k6_stage0_one_launch": _device_ms(torch, lambda: WA.window_attention_cuda(
                *calls[0][0], scale=calls[0][1]), it),
            "k6_all_launches": _device_ms(torch, lambda: [WA.window_attention_cuda(
                *qkv, scale=s) for qkv, s, _, _ in calls], it),
            "k6_copies_stage0_one_block": _device_ms(torch, lambda: copies(
                calls[0][2], calls[0][3], calls[0][0][0]), it),
            "k6_copies_all_blocks": _device_ms(torch, lambda: [copies(
                proj, heads, qkv[0]) for qkv, _, proj, heads in calls], it)}


MODELS = {"colsmol": ("vidore/colSmol-256M", True), "colflor": ("ahmed-masry/ColFlor", False)}
TOWER_PARTS = {"colsmol": _colsmol_parts, "colflor": _colflor_parts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="colsmol")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pages", type=int, default=16, help="pages in the one embedded batch")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this breakdown runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch.models import load_retriever

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    name, dev_pre = MODELS[args.model]
    retr = load_retriever(name, device="cuda", dtype=torch.bfloat16, seed=args.seed,
                          device_preprocess=dev_pre)
    model, proc, n, it = retr.model, retr.processor, args.pages, args.iters
    size = getattr(model.cfg, "image_size", None) or model.cfg.vision.image_size
    rng = np.random.default_rng(args.seed)
    pages = list(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))

    r = {}
    kw = dict(device_preprocess=True) if dev_pre else {}
    t0 = time.perf_counter()
    for _ in range(it):
        batch = proc.process_images(pages, **kw)
    r["host_process_images"] = (time.perf_counter() - t0) * 1e3 / it
    ids = torch.from_numpy(batch["input_ids"]).to("cuda", torch.long)
    mask = torch.from_numpy(batch["attention_mask"]).to("cuda")
    tower = model.vision_model if args.model == "colsmol" else model.vision_tower
    with torch.inference_mode():
        r["upload"] = _device_ms(torch, lambda: retr._pixels(batch["pixel_values"]), it)
        pix = retr._pixels(batch["pixel_values"])
        r["vision_tower"] = _device_ms(torch, lambda: tower(pix), it)
        r["forward"] = _device_ms(torch, lambda: model(ids, mask, pix), it)
        r["rest_of_forward"] = r["forward"] - r["vision_tower"]
        r["tower_host_issue"] = _host_issue_ms(torch, lambda: tower(pix), it)
        feats = tower(pix)
        tower.forward = lambda pixel_values: feats   # the tower's output, given
        r["rest_alone"] = _device_ms(torch, lambda: model(ids, mask, pix), it)
        r["rest_alone_host_issue"] = _host_issue_ms(torch, lambda: model(ids, mask, pix), it)
        del tower.forward, feats
        r.update(TOWER_PARTS[args.model](torch, model, pix, n, it))
        r["embed_images_wall"] = _host_ms(torch, lambda: retr.embed_images(pages, batch_size=n),
                                          it)
        r["pages_per_s"] = n / r["embed_images_wall"] * 1e3

        t0 = time.perf_counter()
        for _ in range(it):
            qb = proc.process_queries(QUERIES)
        r["host_process_queries"] = (time.perf_counter() - t0) * 1e3 / it
        qids = torch.from_numpy(qb["input_ids"]).to("cuda", torch.long)
        qmask = torch.from_numpy(qb["attention_mask"]).to("cuda")
        r["query4_forward"] = _device_ms(torch, lambda: model(qids, qmask, None), it)
        r["query4_wall"] = _host_ms(torch, lambda: retr.embed_queries(QUERIES), it)
        r["query1_wall"] = _host_ms(torch, lambda: retr.embed_queries(QUERIES[:1]), it)
    r.update(card=card, model=name, pages=n, tokens_per_page=int(ids.shape[1]),
             query_tokens=int(qids.shape[1]), iters=it)
    print(f"[{name}: embed {n} pages] host process_images {r['host_process_images']:.2f} ms | "
          f"upload{'+K3' if dev_pre else ''} {r['upload']:.3f} ms | vision tower "
          f"{r['vision_tower']:.2f} ms | whole forward {r['forward']:.2f} ms (rest of the model "
          f"{r['rest_of_forward']:.2f} ms; alone {r['rest_alone']:.2f} ms, host issue "
          f"{r['rest_alone_host_issue']:.2f} ms; tower host issue {r['tower_host_issue']:.2f} "
          f"ms) | embed_images wall {r['embed_images_wall']:.2f} ms "
          f"({r['pages_per_s']:.1f} pages/s) | {r['tokens_per_page']} tokens per page", flush=True)
    print(f"[tower parts at B={n}] " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in r.items() if k[0] == "k" and k[1].isdigit())
          + (f" ({r['tower_k6_launches']} launches)" if "tower_k6_launches" in r else ""),
          flush=True)
    print(f"[queries] 4 x {r['query_tokens']} tokens: host process {r['host_process_queries']:.2f}"
          f" ms, forward {r['query4_forward']:.2f} ms (events), embed_queries wall "
          f"{r['query4_wall']:.2f} ms | 1 query: embed_queries wall {r['query1_wall']:.2f} ms",
          flush=True)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
