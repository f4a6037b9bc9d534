"""K1 and K4 (MaxSim, exact and int8) alone at the retrieval shapes, timed as CUDA-graph replays.

Run from the root of a checkout, on a machine with a CUDA device:

    python -m multimodal_colpali_tpu_torch.maxsim_sweep [--seed N] [--json PATH]
        [--variant FLAGS ...]

The corpus is chip_smoke's phase-2 case: 4,096 pages of up to 1,030 bf16
tokens of 128 (unit-norm random vectors, ragged ``d_lens``, every 97th page
empty), for K4 the same corpus quantized to int8 codes and scales, and for
``K1 f32`` the same corpus in float32 (the CUDA-core kernel, which the
float32 embeddings of ``score_results`` take). The queries are 32 unit-norm
tokens each, at three batches:

- ``B4``: phase 2's four queries, ``q_lens`` 32, 20, 1, 32;
- ``B1``: the store's query (``query_points`` scores one query at a time);
- ``B120``: a sweep's batch of 120 questions, K1 only (bf16 and float32).
  Its plain version would need a ~65 GB intermediate, so it is checked bit
  for bit against the 120 one-query calls stacked.

For each case it prints the device ms of one call (calls captured once as a
CUDA graph and replayed, ``_timing.graph_ms``), the eager per-call ms, the
bound (the larger of the bytes the call must move over 3.35 TB/s and its
products over the peak of their type: bf16 tensor cores, or float32 outside
them), the launches of one call by path, and the error against the plain
version. The cases call only the public wrappers, so the script also times
an older tree's kernels when that tree's package comes first on the path.
Each ``--variant`` (nvcc flags, e.g. ``-DMAXSIM_SKIP_PRODUCTS``: the
tensor-core kernel's copies, waits and launch without the products) times
every case again on ``csrc/maxsim.cu`` built with those flags
(``_build.build_variant``). The first line is the card's name and power
limit as ``nvidia-smi`` prints them; the last is one JSON object with every
number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
P, NT, NQ, DIM = 4096, 1030, 32, 128
CASES = {"B4": [NQ, 20, 1, NQ], "B1": [NQ], "B120": [NQ] * 120}
F32_CASES = ("B4", "B120")


def corpus(torch, g, dev):
    """chip_smoke's phase-2 corpus: bf16 pages, ragged lengths, every 97th empty."""
    import torch.nn.functional as F

    d = torch.empty(P, NT, DIM, dtype=torch.bfloat16, device=dev)
    for s in range(0, P, 512):
        part = torch.randn(min(512, P - s), NT, DIM, generator=g, device=dev)
        d[s: s + 512] = F.normalize(part, dim=-1).to(torch.bfloat16)
    d_lens = torch.randint(1, NT + 1, (P,), generator=g, device=dev, dtype=torch.int32)
    d_lens[::97] = 0
    return d, d_lens


def _paths(fn) -> dict:
    return {k: getattr(fn, f"{k}_launches", None) for k in ("tensor_core", "cuda_core")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write the JSON object to this file")
    ap.add_argument("--variant", action="append", default=[],
                    help="every case again on maxsim.cu built with these nvcc flags")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this sweep runs only on a GPU", file=sys.stderr)
        return 2
    from multimodal_colpali_tpu_torch import _build
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import maxsim as M

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    d, d_lens = corpus(torch, g, dev)
    q32 = F.normalize(torch.randn(120, NQ, DIM, generator=g, device=dev), dim=-1)
    q16 = q32.to(torch.bfloat16)
    codes, scales = M.quantize_corpus_int8(d)
    d32 = d.float()
    live_d = float(d_lens.sum())
    result = {"card": card, "cases": {}}

    def measure(tag, kernel, call, plain, q_lens, nbytes, peak):
        torch.cuda.synchronize()
        before = kernel.launches, _paths(kernel)
        got = call()
        torch.cuda.synchronize()
        launches = kernel.launches - before[0]
        paths = {k: (v - before[1][k] if v is not None else None)
                 for k, v in _paths(kernel).items()}
        err = None
        if plain is not None:
            live = d_lens > 0
            err = float((got[:, live] - plain()[:, live]).abs().max())
        first = eager_ms(call, 1)
        iters = max(2, min(50, int(60.0 / max(first, 1e-3))))
        ms = graph_ms(call, iters)
        eager = eager_ms(call, iters)
        flops = 2.0 * DIM * float(q_lens.sum()) * live_d
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
        res = dict(graph_ms=ms, eager_ms=eager, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   launches=launches, paths=paths, max_abs_err=err)
        result["cases"][tag] = res
        print(f"[{tag}] graph {ms:.4f} ms, eager {eager:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), {launches} launches {paths}, max|err| vs plain {err} | "
              f"{card}", flush=True)
        return got

    def cases(suffix, lib):
        # with a probe build, the same calls through the launch that takes it
        k1 = ((lambda qq, dd, ql: M.maxsim_scores_cuda(qq, dd, ql, d_lens)) if lib is None else
              (lambda qq, dd, ql: M._launch(M.maxsim_scores_cuda, qq, dd, None, ql, d_lens,
                                            lib=lib)))
        k4 = ((lambda qq, ql: M.maxsim_scores_int8_cuda(qq, codes, scales, ql, d_lens))
              if lib is None else
              (lambda qq, ql: M._launch(M.maxsim_scores_int8_cuda, qq, codes, scales, ql,
                                        d_lens, lib=lib)))
        for name, lens in CASES.items():
            b = len(lens)
            q_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            qb, qf = q16[:b].contiguous(), q32[:b].contiguous()
            out_bytes = b * P * 4
            corpora = [("K1", qb, d, 2, BF16_FLOPS)]
            if name in F32_CASES:
                corpora.append(("K1 f32", qf, d32, 4, F32_FLOPS))
            for kname, qq, dd, size, peak in corpora:
                tag = f"{kname} {name}{suffix}"
                got = measure(tag, M.maxsim_scores_cuda, lambda: k1(qq, dd, q_lens),
                              (lambda: M.maxsim_scores_reference(qq, dd, q_lens, d_lens))
                              if b <= 4 else None, q_lens,
                              live_d * DIM * size + qq.numel() * size + out_bytes, peak)
                if b > 4:
                    ones = torch.cat([k1(qq[i: i + 1], dd, q_lens[i: i + 1]) for i in range(b)])
                    same = bool(torch.equal(got, ones))
                    result["cases"][tag]["equals_b1_stacked"] = same
                    print(f"[{tag}] bit for bit the {b} one-query calls stacked: {same}",
                          flush=True)
                del got
            if name != "B120":
                measure(f"K4 {name}{suffix}", M.maxsim_scores_int8_cuda,
                        lambda: k4(qf, q_lens),
                        lambda: M.maxsim_scores_int8_reference(qf, codes, scales, q_lens, d_lens),
                        q_lens, live_d * (DIM + 4) + qf.numel() * 4 + out_bytes, BF16_FLOPS)
            torch.cuda.empty_cache()

    cases("", None)
    for flags in args.variant:
        cases(f" [{flags}]", _build.build_variant("maxsim", flags))
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
