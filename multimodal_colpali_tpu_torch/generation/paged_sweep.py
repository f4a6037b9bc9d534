"""K7a / K7b alone at the decode shapes of gemma-3-27b, timed as CUDA-graph replays.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.generation.paged_sweep [--seed N] [--json PATH]
        [--probe]

Three shapes, 32 q heads over 16 kv heads of 128, pages of 16:

- ``phase2``: chip_smoke's phase-2 case, 8 slots of up to 4,096 tokens
  (lengths 0, 4096, 1839, 3185, 719, 1912, 1049, 96);
- ``decode``: the paged batcher's decode step in
  ``generation.breakdown``, 4 slots of 2,048 tokens (NB = 128) at lengths
  309, 709, 1,109 and 1,509;
- ``floor``: the same 4 slots holding 16 tokens each, where a call is almost
  all fixed cost (its 1-split sweep point has no merge of splits).

For each shape, window (0 and 1,024) and pool type (bf16: K7a; int8 codes
and scales: K7b) it prints the device ms of one call, ``ITERS`` calls
captured once as a CUDA graph and replayed (``_timing.graph_ms``), beside
the eager per-call time, the byte bound (the K and V rows this data needs,
a slot of length 0 counting its V rows only, over 3.35 TB/s) and the split
count; then the K7a call at 1, 2, 3, 4, 6, 8 and 16
splits in place of the plan's. The calls of one replay rotate over ``SETS``
copies of the pools, so that a shape whose rows fit the 50 MB L2 cache is
read from device memory as in a decode step, where each layer has pools of
its own.

With ``--probe``, each K7a/K7b call is timed again on
``csrc/paged_attention.cu`` built with ``-DPAGED_SKIP_PRODUCTS`` (each warp
of the tensor-core path waits for its stage and goes on): the launch, the
copies and the merge of the splits without the products. The first line is
the card's name and power limit as ``nvidia-smi`` prints them; the last is
one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BPS = 3.35e12
ITERS, SETS = 40, 4
SHAPES = {
    "phase2": dict(hq=32, hkv=16, d=128, page=16, nb=256,
                   lengths=[0, 4096, 1839, 3185, 719, 1912, 1049, 96]),
    "decode": dict(hq=32, hkv=16, d=128, page=16, nb=128, lengths=[309, 709, 1109, 1509]),
    "floor": dict(hq=32, hkv=16, d=128, page=16, nb=128, lengths=[16, 16, 16, 16]),
}
SWEEP = (1, 2, 3, 4, 6, 8, 16)


def kv_bytes(lengths, window: int, nb: int, page: int, hkv: int, per_row: int) -> int:
    """Bytes of the K and V rows one call needs: each token's two rows of
    every kv head, a slot of length 0 its NB * page V rows."""
    total = 0
    for n in lengths:
        rows = min(n, window) if window and n else n
        total += (2 * rows if n else nb * page) * hkv * per_row
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write the JSON object to this file")
    ap.add_argument("--probe", action="store_true",
                    help="also time each call with the products skipped")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this sweep runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch import _build
    from multimodal_colpali_tpu_torch._timing import cycle, eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    skip_products = (_build.build_variant("paged_attention", "-DPAGED_SKIP_PRODUCTS")
                     if args.probe else None)
    result = {"card": card, "shapes": {}}
    for shape, c in SHAPES.items():
        hq, hkv, d, page, nb, lengths = (c[k] for k in ("hq", "hkv", "d", "page", "nb",
                                                        "lengths"))
        b = len(lengths)
        n_pages = b * nb + 1
        q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
        bt = torch.randperm(n_pages, generator=g, device=dev)[: b * nb].reshape(b, nb)
        bt = bt.to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        scale = 168.0 ** -0.5
        sets = []
        for _ in range(SETS):
            kp = torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16)
            vp = torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16)
            sets.append((kp, vp, *PA.quantize_kv_rows(kp), *PA.quantize_kv_rows(vp)))
        res = result["shapes"][shape] = {"lengths": lengths, "nb": nb}

        planned = PA.split_plan(b, hkv, nb * page, sms)

        def calls(window, int8, splits=None, lib=None):
            if int8:
                return [lambda s=s: PA._launch(PA.paged_attention_int8_cuda, q, s[2], s[4], s[3],
                                               s[5], bt, lens, scale, window, splits, lib)
                        for s in sets]
            return [lambda s=s: PA._launch(PA.paged_attention_cuda, q, s[0], s[1], None, None,
                                           bt, lens, scale, window, splits, lib) for s in sets]

        for window in (0, 1024):
            for int8 in (False, True):
                tag = f"{'K7b' if int8 else 'K7a'} window {window}"
                fns = calls(window, int8)
                ms = graph_ms(cycle(fns), ITERS)
                eager = eager_ms(cycle(fns), ITERS)
                nbytes = kv_bytes(lengths, window, nb, page, hkv, d + 4 if int8 else 2 * d)
                bound = nbytes / HBM_BPS * 1e3
                res[tag] = dict(graph_ms=ms, eager_ms=eager, bound_ms=bound, splits=planned)
                probe = ""
                if skip_products is not None:
                    skipped = graph_ms(cycle(calls(window, int8, lib=skip_products)), ITERS)
                    res[tag]["products_skipped_ms"] = skipped
                    probe = (f", products skipped {skipped:.4f} ms "
                             f"({nbytes / skipped / 1e9:.2f} TB/s)")
                print(f"[{shape}] {tag}: graph {ms:.4f} ms, eager {eager:.4f} ms{probe}, bound "
                      f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB), {planned} splits | {card}",
                      flush=True)
            sweep = {s: graph_ms(cycle(calls(window, False, splits=s)), ITERS)
                     for s in SWEEP if s <= nb * page // 16}
            res[f"K7a window {window} sweep"] = sweep
            print(f"[{shape}] K7a window {window} by splits (graph ms): "
                  + ", ".join(f"{s}: {v:.4f}" for s, v in sweep.items()), flush=True)
        del sets
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
