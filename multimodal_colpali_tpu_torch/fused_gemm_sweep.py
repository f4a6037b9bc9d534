"""K5 (the fused SigLIP layer) and its four GEMMs alone, timed as CUDA-graph replays.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.fused_gemm_sweep [--seed N] [--rows 8192 ...]
        [--json PATH] [--variant FLAGS ...]

At ColSmol's SigLIP layer (hidden 768, 12 heads of 64, MLP 3,072; random
bf16 weights from ``--seed``, chip_smoke's phase-2 recipe) and each ``--rows``
count M (8,192 is phase 2's ``[8, 1024, 768]``, 16,384 ColSmol's batch of
16), it times:

- each GEMM through ``fused_gemm_cuda``: ``qkv`` (LN1, three segments of
  768), ``out_proj`` (+ residual), ``fc1`` (LN2, + gelu_tanh, 3,072) and
  ``fc2`` (K 3,072, + residual), with its TFLOP/s, its bound (the larger of
  its products over 989 TFLOP/s and its bytes, each operand read once and C
  written once, over 3.35 TB/s), its error against ``gemm_reference``, and
  ``torch.nn.functional.linear`` (cuBLAS) on the same weights and the
  already-normalized bf16 input: the bare product, without LN or epilogue,
  timed only;
- the LayerNorm statistics launch (``ln_stats_cuda``) alone;
- K2 (``fused_attention_cuda``) at ``[M / 1024, 1024, 12, 64]``;
- K5a, K5b and K5c through their wrappers.

Each ``--variant`` (nvcc flags, e.g. ``-DGEMM_SKIP_PRODUCTS``: the loads,
the LN transform and the epilogue without wgmma; ``-DGEMM_SKIP_LN``: the
products without the transform) times the GEMMs again on
``csrc/fused_layer.cu`` built with those flags (``_build.build_variant``),
through the wrapper's private ``_gemm_launch``. The first line is the
card's name and power limit as ``nvidia-smi`` prints them; the last is one
JSON object with every number (ms unless named otherwise).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BPS, BF16_FLOPS = 3.35e12, 989e12
H, HEADS, INTER, S = 768, 12, 3072, 1024


def layer_weights(torch, g, dev):
    """chip_smoke's phase-2 recipe: bf16 weights ~ N(0, 1/fan_in), vectors
    around 1 (LN weights) or 0."""
    def w(o, i):
        return (torch.randn(o, i, generator=g, device=dev) * i ** -0.5).to(torch.bfloat16)

    def v(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).to(torch.bfloat16)

    return dict(ln1=(v(H, 1.0), v(H)), qkv=[w(H, H) for _ in range(3)],
                qkv_b=[v(H) for _ in range(3)], wo=w(H, H), bo=v(H), ln2=(v(H, 1.0), v(H)),
                w1=w(INTER, H), b1=v(INTER), w2=w(H, INTER), b2=v(H))


def gemm_cases(torch, p, x2d, hid):
    """The four GEMMs of a layer at x2d's rows: (a, weights, biases,
    epilogue, kwargs) each; ``hid`` is fc2's input."""
    return {
        "qkv": (x2d, p["qkv"], p["qkv_b"], "bias", dict(ln=p["ln1"], eps=1e-6)),
        "out_proj": (x2d, [p["wo"]], [p["bo"]], "residual", dict(resid=x2d)),
        "fc1": (x2d, [p["w1"]], [p["b1"]], "gelu", dict(ln=p["ln2"], eps=1e-6)),
        "fc2": (hid, [p["w2"]], [p["b2"]], "residual", dict(resid=x2d)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, nargs="+", default=[8192])
    ap.add_argument("--json", default=None, help="also write the JSON object to this file")
    ap.add_argument("--variant", action="append", default=[],
                    help="the GEMMs again on fused_layer.cu built with these nvcc flags")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this sweep runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch import _build
    from multimodal_colpali_tpu_torch._timing import graph_ms
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p = layer_weights(torch, g, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = {flags: _build.build_variant("fused_layer", flags) for flags in args.variant}
    result = {"card": card, "rows": {}}

    def ms_of(fn, iters=20):
        return graph_ms(fn, iters)

    for m in args.rows:
        r = result["rows"][str(m)] = {}
        x = torch.randn(m // S, S, H, generator=g, device=dev).to(torch.bfloat16)
        x2d = x.view(m, H)
        hid = F.gelu(torch.randn(m, INTER, generator=g, device=dev), approximate="tanh").to(
            torch.bfloat16)
        for name, (a, ws, bs, epi, kw) in gemm_cases(torch, p, x2d, hid).items():
            n, k = len(ws) * ws[0].shape[0], a.shape[1]
            flops = 2.0 * m * n * k
            nbytes = 2 * (a.numel() + n * k + m * n) + 4 * n + (2 * m * n if "resid" in kw else 0)
            t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
            got = FL.fused_gemm_cuda(a, ws, bs, epi, **kw)
            want = FL.gemm_reference(a, ws, bs, epi, **kw)
            err = float((got.float() - want.float()).abs().max())
            plan = FL.gemm_plan(m, ws[0].shape[0], len(ws), sms)
            ms = ms_of(lambda: FL.fused_gemm_cuda(a, ws, bs, epi, **kw))
            # cuBLAS: the bare product on the normalized input, one weight [N, K]
            an = FL._layernorm(a, *kw["ln"], 1e-6) if "ln" in kw else a
            wcat = torch.cat(ws) if len(ws) > 1 else ws[0]
            cublas = ms_of(lambda: F.linear(an, wcat))
            row = dict(ms=ms, tflops=flops / ms * 1e-9, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       cublas_ms=cublas, cublas_tflops=flops / cublas * 1e-9, max_abs_err=err,
                       bn=plan.bn, tiles=plan.tiles)
            for flags, lib in variants.items():
                row[f"ms {flags}"] = ms_of(lambda: FL._gemm_launch(a, ws, bs, epi, lib=lib, **kw))
            r[name] = row
            print(f"[M={m} {name}] {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, bn {row['bn']}, "
                  f"{row['tiles']} tiles), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"cuBLAS bare product {cublas:.4f} ms ({row['cublas_tflops']:.1f} TFLOP/s), "
                  f"max|err| vs gemm_reference {err:.3g}"
                  + "".join(f", {k} {v:.4f}" for k, v in row.items() if k.startswith("ms "))
                  + f" | {card}", flush=True)
        r["ln_stats"] = ms_of(lambda: FL.ln_stats_cuda(x2d, 1e-6))
        shape = (m // S, S, HEADS, H // HEADS)
        qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
        r["k2"] = ms_of(lambda: A.fused_attention_cuda(*qkv, scale=(H // HEADS) ** -0.5))
        attn = [*p["ln1"], p["qkv"][0], p["qkv_b"][0], p["qkv"][1], p["qkv_b"][1], p["qkv"][2],
                p["qkv_b"][2], p["wo"], p["bo"]]
        mlp = [*p["ln2"], p["w1"], p["b1"], p["w2"], p["b2"]]
        r["k5a"] = ms_of(lambda: FL.fused_vit_layer_cuda(x, *attn, *mlp, heads=HEADS), 10)
        r["k5b"] = ms_of(lambda: FL.fused_vit_attention_block_cuda(x, *attn, heads=HEADS), 10)
        r["k5c"] = ms_of(lambda: FL.fused_mlp_block_cuda(x, *mlp), 10)
        print(f"[M={m}] ln_stats {r['ln_stats']:.4f} ms | K2 {list(shape)} {r['k2']:.4f} ms | "
              f"K5a {r['k5a']:.4f} ms, K5b {r['k5b']:.4f} ms, K5c {r['k5c']:.4f} ms | {card}",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
