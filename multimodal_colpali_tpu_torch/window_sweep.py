"""K6 (window attention) and K3 (pixel normalize) alone, timed as CUDA-graph replays.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.window_sweep [--seed N] [--json PATH]
        [--variant FLAGS ...]

It times:

- K6 through ``window_attention_cuda`` in bf16 at ColFlor's four DaViT
  stage shapes at batch 8 (12 x 12 windows, head_dim 32: ``[8192 | 4096 |
  2048 | 1024, 144, 32]``), with its bound (q, k and v read once, the output
  written once, over 3.35 TB/s), its error against the plain version, and
  ``scaled_dot_product_attention`` on the same inputs as ``[N, 1, S, D]``
  (timed only). The last two shapes (57 and 28 MB of q, k and v) partly fit
  in the 50 MB L2;
- K6's 12 launches of one ColFlor forward at batch 8 (DaViT depths 1/1/9/1);
- K3 through ``normalize_images`` at ``[8, 448, 448, 3]`` uint8, the graph
  cycling over 12 input sets (57.8 MB of pixels alone, past the L2), and
  eager calls as Python issues them (the host's issue time).

Each ``--variant`` (nvcc flags: ``-DWINDOW_LOADS_ONLY``, the ring's copies
alone; ``-DWINDOW_SKIP_STORE``, no output written; ``-DWINDOW_SKIP_SOFTMAX``,
the products, copies and stores without the softmax) times K6 again on
``csrc/window_attention.cu`` built with those flags
(``_build.build_variant``), through the private ``_launch``. The first line
is the card's name and power limit as ``nvidia-smi`` prints them; the last
is one JSON object with every number (ms unless named otherwise).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HBM_BPS = 3.35e12
STAGES = {"stage0": 8192, "stage1": 4096, "stage2": 2048, "stage3": 1024}
S, D = 144, 32
DEPTHS = (1, 1, 9, 1)           # ColFlor's DaViT blocks a stage
K3_SHAPE = (8, 448, 448, 3)
K3_SETS = 12                    # 12 x 4.8 MB of pixels: more than the 50 MB L2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write the JSON object to this file")
    ap.add_argument("--variant", action="append", default=[],
                    help="K6 again on window_attention.cu built with these nvcc flags")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this sweep runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch import _build
    from multimodal_colpali_tpu_torch._timing import cycle, eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import preprocess as PP
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    with ThreadPoolExecutor(max(1, len(args.variant))) as pool:   # nvcc in parallel
        variants = dict(zip(args.variant, pool.map(
            lambda flags: _build.build_variant("window_attention", flags), args.variant)))
    result = {"card": card, "k6": {"ring_grid": WA.ring_grid()}, "k3": {}}
    scale = D ** -0.5

    qkv_of = {}
    for name, n in STAGES.items():
        qkv = qkv_of[name] = [torch.randn(n, S, D, generator=g, device=dev).to(torch.bfloat16)
                              for _ in range(3)]
        got = WA.window_attention_cuda(*qkv, scale=scale)
        want = WA.window_attention_reference(*qkv, scale=scale)
        err = float((got.float() - want.float()).abs().max())
        ms = graph_ms(lambda: WA.window_attention_cuda(*qkv, scale=scale), 20)
        qt, kt, vt = (x[:, None] for x in qkv)
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20)
        nbytes = 4 * qkv[0].numel() * 2
        row = dict(ms=ms, bound_ms=nbytes / HBM_BPS * 1e3, tb_s=nbytes / ms * 1e-9,
                   sdpa_ms=sdpa, max_abs_err=err)
        for flags, lib in variants.items():
            out = torch.empty_like(qkv[0])
            WA._launch(*qkv, out, scale, lib=lib)
            row[f"max_abs_err {flags}"] = float((out.float() - want.float()).abs().max())
            row[f"ms {flags}"] = graph_ms(lambda: WA._launch(*qkv, out, scale, lib=lib), 20)
        result["k6"][name] = row
        print(f"[K6 {name} {list(qkv[0].shape)}] {ms:.4f} ms ({row['tb_s']:.2f} TB/s, bound "
              f"{row['bound_ms']:.4f}), sdpa {sdpa:.4f}, max|err| {err:.3g}"
              + "".join(f" | {f}: {row[f'ms {f}']:.4f} ms, max|err| "
                        f"{row[f'max_abs_err {f}']:.3g}" for f in variants), flush=True)
        del got, want

    calls = [qkv_of[name] for name, depth in zip(STAGES, DEPTHS) for _ in range(depth)]
    forward = graph_ms(lambda: [WA.window_attention_cuda(*qkv, scale=scale) for qkv in calls], 5)
    result["k6"]["forward_12_launches"] = forward
    print(f"[K6 a ColFlor forward at batch 8] 12 launches {forward:.4f} ms", flush=True)
    del qkv_of, calls
    torch.cuda.empty_cache()

    xs = [torch.randint(0, 256, K3_SHAPE, generator=g, device=dev, dtype=torch.int32).to(
        torch.uint8) for _ in range(K3_SETS)]
    got = PP.normalize_images(xs[0])
    want = PP.normalize_images_reference(xs[0])
    ulps = int((got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max())
    graph = graph_ms(cycle([lambda x=x: PP.normalize_images(x) for x in xs]), 20)
    eager = eager_ms(lambda: PP.normalize_images(xs[0]), 20)
    nbytes = 3 * xs[0].numel()
    result["k3"] = dict(graph_ms=graph, eager_ms=eager, bound_ms=nbytes / HBM_BPS * 1e3,
                        tb_s=nbytes / graph * 1e-9, max_ulps=ulps)
    print(f"[K3 {list(K3_SHAPE)}] graph {graph:.4f} ms ({result['k3']['tb_s']:.2f} TB/s, bound "
          f"{result['k3']['bound_ms']:.4f}), eager {eager:.4f} ms, max {ulps} ulp", flush=True)

    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
