"""Serve generation from the port's decode engine over OpenAI HTTP.

The counterpart of ``drivers/07_serve.py`` for the Gemma-3 generators
(``models/registry.GEMMA3_CONFIGS``), the old-model tier's Qwen2-VL and
LLaVA-NeXT generators and their LMs (``QWEN2VL_CONFIGS``,
``LLAVA_NEXT_CONFIGS``, ``LLAMA_CONFIGS``) and the ColPali retrievers: it
loads the model through the registry (its checkpoint under
``COLPALI_TPU_CKPT_DIR``, else random weights from a seed, with a warning),
wraps it in the decode engine and a continuous batcher and serves
``/v1/chat/completions`` and ``/health``. Requests with ``image_url`` parts
are answered on their images by an image engine whose LM is the text
engine: a ``Qwen2VLMMEngine`` for a Qwen2-VL name (07_serve.py:125-152), a
``LlavaNextMMEngine`` for LLaVA-NeXT (:153-178; a bare Llama name serves
text only, :206-217), a ``Gemma3MMEngine`` (SigLIP at 896 px,
``load_gemma3_mm``) for a Gemma-3 name with a multimodal config
(07_serve.py:218-245), an ``MllamaMMEngine`` for a Llama-3.2-Vision name
(07_serve.py:179-205; ``--tiles RxC`` the static tile layout, ``--cross-max-images
N`` the images a slot's cross pools hold), a ``PaliGemmaEngine`` on the same
weights for a ColPali retriever (07_serve.py:255-277). gemma-3-1b is text-only upstream and
is served as text (JAX's 07 raises ``KeyError`` for it). ``--speculative K``
serves through the speculative dense or paged batcher (prompt lookup, K
tokens verified a forward; 07_serve.py:294-312). Image data URLs decode with
the port's own PNG and JPEG decoders. It runs on the GPU unless ``--device
cpu`` asks for the CPU.

Example:
  python -m multimodal_colpali_tpu_torch.serve --model gemma-3-27b --paged \\
      --max-seq-len 2048 [--prefix-caching] [--kv-dtype int8] [--weight-dtype int8|int4]
  COLPALI_TPU_CKPT_DIR=/ckpts python -m multimodal_colpali_tpu_torch.serve \\
      --model vidore/colpali-v1.3 --paged --max-seq-len 6144
  python -m multimodal_colpali_tpu_torch.serve --model AdaptLLM/biomed-Qwen2-VL-2B-Instruct \\
      --paged --max-seq-len 6144 --speculative 4
  python -m multimodal_colpali_tpu_torch.serve --model llama-3.2-11b-vision --paged \\
      --max-seq-len 6144 [--tiles 2x2] [--cross-max-images 5]
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve the port's generation engine.")
    p.add_argument("--model", default="tiny-colpali",
                   help="A Gemma-3, Qwen2-VL, LLaVA-NeXT, Llama-3.2-Vision or Llama generator, or a "
                        "colpali-family retriever (its Gemma LM is served).")
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
                   help="Vision tower weights (Gemma-3's SigLIP, Qwen2-VL's tower, "
                        "LLaVA-NeXT's CLIP): int8 makes its projections W8A8 (int8 "
                        "activations and weights, int32 sums); a projector stays in --dtype.")
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
    p.add_argument("--tiles", default="1x1", metavar="RxC",
                   help="Llama-3.2-Vision: the static tile layout of every image (2x2 gives "
                        "document pages 4x the pixels); one of the checkpoint's aspect ratios.")
    p.add_argument("--cross-max-images", type=int, default=10, metavar="N",
                   help="Llama-3.2-Vision: images a slot's cross-KV pools hold at the tile "
                        "layout (10: the reference's --limit_mm_per_prompt).")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="Prompt-lookup speculative decoding: verify K drafted tokens a slot a "
                        "forward (greedy slots accept; sampled slots advance one). Composes "
                        "with --paged.")
    return p.parse_args(argv)


def build(args: argparse.Namespace):
    """(engine, tokenizer, mm_engine, image_preprocessor) for ``args.model``;
    the last two are None for a text-only model (gemma-3-1b, a bare Llama)."""
    from multimodal_colpali_tpu_torch.generation.engine import (
        GemmaDecodeEngine, LlamaDecodeEngine, PaliGemmaEngine)
    from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_state_dict
    from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor
    from multimodal_colpali_tpu_torch.models.registry import (
        GEMMA3_CONFIGS, GEMMA3_MM_CONFIGS, load_gemma3_lm, load_gemma3_mm, load_retriever)

    from multimodal_colpali_tpu_torch.models import registry as R

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    load = dict(device=args.device, dtype=dtype, weight_dtype=args.weight_dtype)
    if args.model in R.QWEN2VL_CONFIGS or args.model in R.LLAVA_NEXT_CONFIGS:
        return _build_old_model(args, load)
    if args.model in R.MLLAMA_CONFIGS:
        return _build_mllama(args, load)
    if args.model in R.LLAMA_CONFIGS:
        # a bare Llama LM (LLaVA-NeXT's decoder without the tower): text only
        cfg, params, tok = R.load_llama_lm(args.model, **load)
        engine = LlamaDecodeEngine(cfg, params, dtype=dtype, weight_dtype=args.weight_dtype,
                                   device=args.device)
        return engine, tok or _random_tokenizer(cfg.vocab_size), None, None
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
            raise SystemExit(f"serving supports the Gemma-LM (colpali) family, the gemma3 "
                             f"LMs ({sorted(GEMMA3_CONFIGS)}), the qwen2-vl LMs "
                             f"({sorted(R.QWEN2VL_CONFIGS)}), the llava-next VLMs "
                             f"({sorted(R.LLAVA_NEXT_CONFIGS)}) and the llama LMs "
                             f"({sorted(R.LLAMA_CONFIGS)}); {args.model!r} is "
                             f"{retriever.family!r}")
        cfg = retriever.model.cfg.text
        params = engine_params_from_state_dict(retriever.model.state_dict())
        tok = getattr(retriever.processor, "tokenizer", None)
        if tok is None or not hasattr(tok, "decode"):
            tok = None
    engine = GemmaDecodeEngine(cfg, params, dtype=dtype, weight_dtype=args.weight_dtype,
                               device=args.device)
    tok = tok or _random_tokenizer(cfg.vocab_size)
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


def _random_tokenizer(vocab_size: int):
    """Random-weight serving: ids must fit the model vocab."""
    from multimodal_colpali_tpu_torch.generation.engine import ByteTokenizer, ModuloTokenizer

    return ByteTokenizer() if vocab_size >= 259 else ModuloTokenizer(vocab_size)


def _build_old_model(args: argparse.Namespace, load: dict):
    """A Qwen2-VL or LLaVA-NeXT generator (07_serve.py:125-178): the text
    engine over the LM (quantized once, under ``--weight-dtype``) and the
    image engine decoding through it, the tower made W8A8 under
    ``--vision-dtype int8``; the preprocessor resizes on ``--device``."""
    from multimodal_colpali_tpu_torch.generation.engine import (
        LlamaDecodeEngine, Qwen2DecodeEngine)
    from multimodal_colpali_tpu_torch.generation.llava_next_mm import (
        LlavaNextImagePreprocessor, LlavaNextMMEngine)
    from multimodal_colpali_tpu_torch.generation.qwen2vl_mm import (
        Qwen2VLImagePreprocessor, Qwen2VLMMEngine)
    from multimodal_colpali_tpu_torch.models import registry as R

    qwen = args.model in R.QWEN2VL_CONFIGS
    cfg, params, tok = (R.load_qwen2vl_mm if qwen else R.load_llava_next_mm)(args.model, **load)
    cls = Qwen2DecodeEngine if qwen else LlamaDecodeEngine
    engine = cls(cfg.text, params, dtype=load["dtype"], weight_dtype=args.weight_dtype,
                 device=args.device)
    if qwen:
        mm = Qwen2VLMMEngine(cfg, params["visual"], engine, vision_dtype=args.vision_dtype)
        pre = Qwen2VLImagePreprocessor(cfg, device=args.device)
    else:
        mm = LlavaNextMMEngine(cfg, params["vision_tower"], params["multi_modal_projector"],
                               engine, vision_dtype=args.vision_dtype)
        pre = LlavaNextImagePreprocessor(cfg, device=args.device)
    return engine, tok or _random_tokenizer(cfg.text.vocab_size), mm, pre


def _build_mllama(args: argparse.Namespace, load: dict):
    """Llama-3.2-Vision (07_serve.py:179-205): the text engine over the
    renumbered self-attention layers (a plain Llama) and the image engine
    decoding through it with the cross blocks, at ``--tiles``."""
    from multimodal_colpali_tpu_torch.generation.engine import LlamaDecodeEngine
    from multimodal_colpali_tpu_torch.generation.mllama_mm import (
        MllamaImagePreprocessor, MllamaMMEngine)
    from multimodal_colpali_tpu_torch.models import registry as R

    cfg, params, tok = R.load_mllama_mm(args.model, **load)
    engine = LlamaDecodeEngine(cfg.text, params, dtype=load["dtype"],
                               weight_dtype=args.weight_dtype, device=args.device)
    tiles = tuple(int(x) for x in args.tiles.lower().split("x"))
    mm = MllamaMMEngine(cfg, params["vision_tower"], params["multi_modal_projector"],
                        params["cross_layers"], engine, vision_dtype=args.vision_dtype,
                        tiles=tiles)
    pre = MllamaImagePreprocessor(cfg, tiles=tiles, device=args.device)
    return engine, tok or _random_tokenizer(cfg.text.vocab_size), mm, pre


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
        if getattr(mm_engine, "cross_decode", False):
            kw["cross_max_images"] = args.cross_max_images
        if args.speculative:
            from multimodal_colpali_tpu_torch.generation.speculative import (
                SpeculativeContinuousBatcher, SpeculativePagedContinuousBatcher)

            kw["spec_k"] = args.speculative
            paged_cls, dense_cls = (SpeculativePagedContinuousBatcher,
                                    SpeculativeContinuousBatcher)
        else:
            paged_cls, dense_cls = PagedContinuousBatcher, ContinuousBatcher
        if args.paged:
            batcher = paged_cls(engine, page_size=args.page_size, pool_pages=args.pool_pages,
                                kv_dtype=args.kv_dtype, prefix_caching=args.prefix_caching,
                                **kw)
        else:
            batcher = dense_cls(engine, **kw)
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
