"""Where one decode step of the paged batcher goes, at gemma-3-27b's full width.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.generation.breakdown [--seed N] [--iters 5]

It loads ``google/gemma-3-27b-it`` with random weights from ``--seed`` on the
card and, for four configurations in turn - bf16 weights and pools (K7a),
bf16 weights and int8 pools (K7b), int8 weights (K8a, K8b) and bf16 pools,
int4 weights (K9, and K8b for the int8 table) and bf16 pools -
admits four requests of 300, 700, 1,100 and 1,500 tokens into a
``PagedContinuousBatcher`` (4 slots of 2,048 tokens, pages of 16) and times:

- the prefill of the 1,500-token prompt, host clock ending in a sync;
- one decode step of all four slots, host clock ending in a sync (the wall
  time a step takes from eager PyTorch);
- the same step captured once as a CUDA graph and replayed, CUDA events:
  the device time of the step without the host's launch overhead; the
  step's idle share is 1 - graph / wall;
- the step's parts, each captured as a CUDA graph and replayed under CUDA
  events (so a part whose kernels are shorter than their launches is not
  timed by the host): the 7 x 62 projections (bf16 matmuls, K8a or K9), the
  62 paged-attention launches at the slots' lengths (K7a or K7b), the tied
  LM head (bf16 product or K8b).

Every figure is the mean of ``--iters`` runs after a warm-up. The first line
is the card's name and power limit as ``nvidia-smi`` prints them; the last
is one JSON object with every number, in ms unless named otherwise.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

MODEL = "google/gemma-3-27b-it"
PROMPTS = (300, 700, 1100, 1500)


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


def _graph_ms(torch, fn, iters: int) -> float:
    """Device ms of ``fn`` captured once as a CUDA graph and replayed: its
    kernels back to back, without the host's launch time."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                       # warm-up on the capture stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    ms = _device_ms(torch, graph.replay, iters)
    del graph
    return ms


def measure(torch, engine, kv_dtype: str, iters: int, seed: int) -> dict:
    """The figures of one configuration (module docstring)."""
    import numpy as np

    from multimodal_colpali_tpu_torch.generation.engine import attn_scale
    from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
    from multimodal_colpali_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_int8)
    from multimodal_colpali_tpu_torch.ops.quant import q_dense, q_logits

    cfg, p = engine.cfg, engine.params
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, cfg.vocab_size - 8, n).tolist() for n in PROMPTS]
    bat = PagedContinuousBatcher(engine, batch_slots=4, max_seq_len=2048, chunk=8,
                                 page_size=16, kv_dtype=kv_dtype, prefill_cache_entries=0)
    r = {"prefill_1500_wall": _host_ms(torch, lambda: bat._prefill(prompts[-1], 1504), iters)}
    for pr in prompts:
        bat.submit(pr, max_new_tokens=512)
    with torch.inference_mode():
        bat._admit()
        # pages for every step timed below, then the block table once
        for slot in range(bat.B):
            if bat._slots[slot] is None or not bat._alloc_to(slot, int(bat._len[slot])
                                                             + 4 * iters + 16):
                raise RuntimeError(f"slot {slot} was not admitted with room to decode")
        bat._flags = (False, False)
        bat._bt = bat._tensor(bat._bt_host, torch.int32)
        r["decode_step_wall"] = _host_ms(torch, lambda: bat._one_step(p), iters)

        r["decode_step_graph"] = _graph_ms(torch, lambda: bat._one_step(p), iters)
        r["idle_share"] = 1.0 - r["decode_step_graph"] / r["decode_step_wall"]

        b = bat.B
        x = torch.randn(b, 1, cfg.hidden_size, device=engine.device).to(engine.dtype)
        xi = torch.randn(b, 1, cfg.intermediate_size, device=engine.device).to(engine.dtype)
        xo = torch.randn(b, 1, cfg.num_attention_heads * cfg.head_dim,
                         device=engine.device).to(engine.dtype)

        def projections():
            for i in range(cfg.num_hidden_layers):
                lp = p["language_model"][f"layers_{i}"]
                for name in ("q_proj", "k_proj", "v_proj"):
                    q_dense(x, lp["self_attn"][name]["kernel"])
                q_dense(xo, lp["self_attn"]["o_proj"]["kernel"])
                q_dense(x, lp["mlp"]["gate_proj"]["kernel"])
                q_dense(x, lp["mlp"]["up_proj"]["kernel"])
                q_dense(xi, lp["mlp"]["down_proj"]["kernel"])

        q = torch.randn(b, cfg.num_attention_heads, cfg.head_dim,
                        device=engine.device).to(engine.dtype)
        lens = (bat._len + 1).to(torch.int32)
        sc = attn_scale(cfg)

        def attention():
            for i in range(cfg.num_hidden_layers):
                w = bat._layer_window(i)
                if kv_dtype == "int8":
                    kp, vp = bat._kpools[i], bat._vpools[i]
                    paged_attention_int8(q, kp[0], kp[1], vp[0], vp[1], bat._bt, lens,
                                         scale=sc, window=w)
                else:
                    paged_attention(q, bat._kpools[i], bat._vpools[i], bat._bt, lens, scale=sc,
                                    window=w)

        r["projections_62_layers"] = _graph_ms(torch, projections, iters)
        r["paged_attention_62_layers"] = _graph_ms(torch, attention, iters)
        h = torch.randn(b, cfg.hidden_size, device=engine.device)
        r["lm_head"] = _graph_ms(torch, lambda: q_logits(
            h, p["embed"]["embed_tokens"], out_dim=cfg.vocab_size), iters)
        r["rest_of_step_device"] = (r["decode_step_graph"] - r["projections_62_layers"]
                                    - r["paged_attention_62_layers"] - r["lm_head"])
        r["slot_lengths"] = [int(n) for n in bat._len.tolist()]
    del bat
    gc.collect()
    torch.cuda.empty_cache()
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this breakdown runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
    from multimodal_colpali_tpu_torch.models.registry import load_gemma3_lm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    out = {"card": card, "model": MODEL, "prompts": PROMPTS, "iters": args.iters}
    for weights in ("bf16", "int8", "int4"):
        cfg, params, _ = load_gemma3_lm(MODEL, device="cuda", dtype=torch.bfloat16,
                                        seed=args.seed,
                                        weight_dtype="native" if weights == "bf16" else weights)
        engine = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, device="cuda")
        for kv in (("native", "int8") if weights == "bf16" else ("native",)):
            name = f"{weights}_weights_{kv}_kv"
            with torch.inference_mode():
                r = out[name] = measure(torch, engine, kv, args.iters, args.seed)
            print(f"[{name}] prefill 1500 tokens {r['prefill_1500_wall']:.1f} ms (host clock) | "
                  f"decode step of 4 slots at {r['slot_lengths']}: wall "
                  f"{r['decode_step_wall']:.2f} ms, device (CUDA graph replay) "
                  f"{r['decode_step_graph']:.2f} ms, idle share {r['idle_share']:.3f} | parts "
                  f"(graph replay): projections {r['projections_62_layers']:.2f}, paged attention "
                  f"{r['paged_attention_62_layers']:.2f}, LM head {r['lm_head']:.3f}, rest "
                  f"{r['rest_of_step_device']:.2f} ms | {card}", flush=True)
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
