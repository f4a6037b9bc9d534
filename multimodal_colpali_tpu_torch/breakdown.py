"""Where ColSmol-256M's time goes on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.breakdown [--seed N] [--pages 16] [--iters 5]

It loads full-width ``vidore/colSmol-256M`` with random bf16 weights from
``--seed`` and ``device_preprocess=True`` (the configuration of
``chip_smoke.py``'s phase 4) and times, for one batch of ``--pages``
synthetic 512x512 pages and for 4 queries, each part of the embedding path:

- host ``process_images`` (the resize) and ``process_queries``, host clock;
- upload + K3, the vision tower (every SigLIP layer as K5a, then the final
  LayerNorm), one K5a layer, its two halves K5b and K5c, and the whole model
  forward, each with CUDA events; connector + Llama + head is the forward
  less the tower;
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pages", type=int, default=16, help="pages in the one embedded batch")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this breakdown runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    retr = load_retriever("vidore/colSmol-256M", device="cuda", dtype=torch.bfloat16,
                          seed=args.seed, device_preprocess=True)
    model, proc, n, it = retr.model, retr.processor, args.pages, args.iters
    size = proc.image_preprocessor.image_size
    rng = np.random.default_rng(args.seed)
    pages = list(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))

    r = {}
    t0 = time.perf_counter()
    for _ in range(it):
        batch = proc.process_images(pages, device_preprocess=True)
    r["host_process_images"] = (time.perf_counter() - t0) * 1e3 / it
    ids = torch.from_numpy(batch["input_ids"]).to("cuda", torch.long)
    mask = torch.from_numpy(batch["attention_mask"]).to("cuda")
    with torch.inference_mode():
        r["upload_k3"] = _device_ms(torch, lambda: retr._pixels(batch["pixel_values"]), it)
        pix = retr._pixels(batch["pixel_values"])
        r["vision_tower"] = _device_ms(torch, lambda: model.vision_model(pix), it)
        r["forward"] = _device_ms(torch, lambda: model(ids, mask, pix), it)
        r["connector_llama_head"] = r["forward"] - r["vision_tower"]
        layer = model.vision_model.layers[0]
        c = layer.cfg
        x = torch.randn(n, c.num_patches, c.hidden_size, device="cuda").to(torch.bfloat16)
        eps, heads = c.layer_norm_eps, c.num_attention_heads
        r["k5a_layer"] = _device_ms(torch, lambda: FL.fused_vit_layer_cuda(
            x, *layer._attn_params(), *layer._mlp_params(), heads=heads, eps=eps), it)
        r["k5b_attn_half"] = _device_ms(torch, lambda: FL.fused_vit_attention_block_cuda(
            x, *layer._attn_params(), heads=heads, eps=eps), it)
        r["k5c_mlp_half"] = _device_ms(torch, lambda: FL.fused_mlp_block_cuda(
            x, *layer._mlp_params(), eps=eps), it)
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
    r.update(card=card, pages=n, tokens_per_page=int(ids.shape[1]),
             query_tokens=int(qids.shape[1]), iters=it)
    print(f"[embed {n} pages] host process_images {r['host_process_images']:.2f} ms | upload+K3 "
          f"{r['upload_k3']:.3f} ms | vision tower {r['vision_tower']:.2f} ms | whole forward "
          f"{r['forward']:.2f} ms (connector + Llama + head {r['connector_llama_head']:.2f} ms) "
          f"| embed_images wall {r['embed_images_wall']:.2f} ms ({r['pages_per_s']:.1f} pages/s)"
          f" | {r['tokens_per_page']} tokens per page", flush=True)
    print(f"[one SigLIP layer at B={n}] K5a {r['k5a_layer']:.3f} ms | K5b (attention half) "
          f"{r['k5b_attn_half']:.3f} ms | K5c (MLP half) {r['k5c_mlp_half']:.3f} ms", flush=True)
    print(f"[queries] 4 x {r['query_tokens']} tokens: host process {r['host_process_queries']:.2f}"
          f" ms, forward {r['query4_forward']:.2f} ms (events), embed_queries wall "
          f"{r['query4_wall']:.2f} ms | 1 query: embed_queries wall {r['query1_wall']:.2f} ms",
          flush=True)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
