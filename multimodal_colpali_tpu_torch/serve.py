"""Serve generation from the port's decode engine over OpenAI HTTP.

The counterpart of ``drivers/07_serve.py`` for the Gemma-3 generators
(``models/registry.GEMMA3_CONFIGS``) and the ColPali retrievers: it loads the
model through the registry (its checkpoint under ``COLPALI_TPU_CKPT_DIR``,
else random weights from a seed, with a warning),
wraps it in the decode engine and a continuous batcher and serves
``/v1/chat/completions`` and ``/health``. Requests with ``image_url`` parts
are answered on their images by an image engine whose LM is the text
engine: a ``Gemma3MMEngine`` (SigLIP at 896 px, ``load_gemma3_mm``) for a
Gemma-3 name with a multimodal config (07_serve.py:218-245), a
``PaliGemmaEngine`` on the same weights for a ColPali retriever
(07_serve.py:255-277). gemma-3-1b is text-only upstream and is served as
text (JAX's 07 raises ``KeyError`` for it). It runs on the GPU unless
``--device cpu`` asks for the CPU.

Example:
  python -m multimodal_colpali_tpu_torch.serve --model gemma-3-27b --paged \\
      --max-seq-len 2048 [--prefix-caching] [--kv-dtype int8] [--weight-dtype int8|int4]
  COLPALI_TPU_CKPT_DIR=/ckpts python -m multimodal_colpali_tpu_torch.serve \\
      --model vidore/colpali-v1.3 --paged --max-seq-len 6144
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve the port's generation engine.")
    p.add_argument("--model", default="tiny-colpali",
                   help="A Gemma-3 LM or a colpali-family retriever (its Gemma LM is served).")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8006)
    p.add_argument("--slots", type=int, default=4, help="Continuous-batching slot count.")
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=8, help="Decode tokens per scheduling point.")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    p.add_argument("--no-batcher", action="store_true",
                   help="Serve straight from the engine (one request at a time).")
    p.add_argument("--paged", action="store_true",
                   help="Use the paged-KV batcher (shared page pool + preemption).")
    p.add_argument("--page-size", type=int, default=16, help="Tokens per KV page (--paged).")
    p.add_argument("--pool-pages", type=int, default=None,
                   help="Pages in the shared pool (--paged); default sizes every slot "
                        "to max-seq-len.")
    p.add_argument("--weight-dtype", default="native", choices=["native", "int8", "int4"],
                   help="Weight-only quantization of the LM: int8 runs every projection "
                        "and the tied head through the int8 kernels (K8a, K8b); int4 runs "
                        "every projection through the group-wise int4 kernel (K9) and the "
                        "head, whose table stays int8, through K8b.")
    p.add_argument("--vision-dtype", default="native", choices=["native", "int8"],
                   help="SigLIP tower weights (Gemma-3 multimodal only): int8 makes its "
                        "projections W8A8 (int8 activations and weights, int32 sums); the "
                        "projector stays in --dtype.")
    p.add_argument("--kv-dtype", default="native", choices=["native", "int8"],
                   help="KV pool storage (--paged): int8 codes + per-token scales (K7b).")
    p.add_argument("--prefix-caching", action="store_true",
                   help="Share identical full prompt pages between requests (--paged).")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="Chunked prefill: prompts longer than this prefill in segments "
                        "(0 = off).")
    p.add_argument("--max-queue", type=int, default=0, metavar="N",
                   help="Bound the admission queue: submits past N get HTTP 429 (0 = no bound).")
    p.add_argument("--admission-timeout", type=float, default=0.0, metavar="SECONDS",
                   help="A request queued longer than this gets HTTP 504 (0 = none).")
    return p.parse_args(argv)


def build(args: argparse.Namespace):
    """(engine, tokenizer, mm_engine, image_preprocessor) for ``args.model``;
    the last two are None for a text-only model (gemma-3-1b)."""
    from multimodal_colpali_tpu_torch.generation.engine import (
        ByteTokenizer, GemmaDecodeEngine, ModuloTokenizer, PaliGemmaEngine)
    from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_state_dict
    from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor
    from multimodal_colpali_tpu_torch.models.registry import (
        GEMMA3_CONFIGS, GEMMA3_MM_CONFIGS, load_gemma3_lm, load_gemma3_mm, load_retriever)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    retriever = mm_parts = None
    if args.model in GEMMA3_MM_CONFIGS:
        cfg_mm, params, tok = load_gemma3_mm(args.model, device=args.device, dtype=dtype,
                                             weight_dtype=args.weight_dtype)
        cfg = cfg_mm.text
        mm_parts = (cfg_mm, params.pop("vision_tower"), params.pop("multi_modal_projector"))
    elif args.model in GEMMA3_CONFIGS:
        cfg, params, tok = load_gemma3_lm(args.model, device=args.device, dtype=dtype,
                                          weight_dtype=args.weight_dtype)
    else:
        retriever = load_retriever(args.model, device=args.device, dtype=dtype)
        if retriever.family != "colpali":
            raise SystemExit(f"serving supports the Gemma-LM (colpali) family and the "
                             f"gemma3 LMs ({sorted(GEMMA3_CONFIGS)}); {args.model!r} "
                             f"is {retriever.family!r}")
        cfg = retriever.model.cfg.text
        params = engine_params_from_state_dict(retriever.model.state_dict())
        tok = getattr(retriever.processor, "tokenizer", None)
        if tok is None or not hasattr(tok, "decode"):
            tok = None
    engine = GemmaDecodeEngine(cfg, params, dtype=dtype, weight_dtype=args.weight_dtype,
                               device=args.device)
    if tok is None:
        # random-weight serving: ids must fit the model vocab
        tok = ByteTokenizer() if cfg.vocab_size >= 259 else ModuloTokenizer(cfg.vocab_size)
    mm_engine = image_pre = None
    if mm_parts is not None:
        # the LM's tree exists once: the image engine decodes through this one
        cfg_mm, tower, projector = mm_parts
        mm_engine = Gemma3MMEngine(cfg_mm, tower, projector, lm=engine,
                                   vision_dtype=args.vision_dtype)
        image_pre = ImagePreprocessor(cfg_mm.vision.image_size)
    elif retriever is not None:
        # image-conditioned generation on the same weights, its LM the text
        # engine itself (quantized or not)
        mm_engine = PaliGemmaEngine(retriever.model, lm=engine)
        image_pre = retriever.processor.image_preprocessor
    return engine, tok, mm_engine, image_pre


def main(argv=None) -> None:
    args = parse_args(argv)
    from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
    from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
    from multimodal_colpali_tpu_torch.generation.server import GenerationServer

    engine, tok, mm_engine, image_pre = build(args)
    backend, batcher = engine, None
    if not args.no_batcher:
        kw = dict(batch_slots=args.slots, max_seq_len=args.max_seq_len, chunk=args.chunk,
                  eos_id=getattr(tok, "eos_id", -1), mm_engine=mm_engine,
                  prefill_chunk=args.prefill_chunk, max_queue=args.max_queue,
                  admission_timeout=args.admission_timeout)
        if args.paged:
            batcher = PagedContinuousBatcher(engine, page_size=args.page_size,
                                             pool_pages=args.pool_pages,
                                             kv_dtype=args.kv_dtype,
                                             prefix_caching=args.prefix_caching, **kw)
        else:
            batcher = ContinuousBatcher(engine, **kw)
        backend = batcher.serve()
    srv = GenerationServer(backend, tok, model_name=args.model, host=args.host,
                           port=args.port, max_new_tokens=args.max_new_tokens,
                           mm_engine=mm_engine, image_preprocessor=image_pre).start()
    print(f"[serve] {args.model} on {srv.base_url} "
          f"(slots={0 if args.no_batcher else args.slots}, device {engine.device})", flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        if batcher is not None:
            batcher.shutdown()


if __name__ == "__main__":
    main()
