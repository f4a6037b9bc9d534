#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``. It
drives ``multimodal_colpali_tpu_torch`` (never JAX) and prints one line per
phase; any failure exits non-zero.

1. Device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the build time of the kernels (nvcc for K1/K4, K2, K2's
   backward, K3, the K5 GEMM, K6, K7a/K7b, K8a/K8b and K9 into
   ``build/kernels``, all at once).
2. Kernels against their plain PyTorch versions, both on the card, at the
   main paths' shapes, with the time of each beside its bound (the larger of
   the bytes it must move over 3.35 TB/s and its operations over the peak
   rate of their type): K1 MaxSim and K4 int8 MaxSim (4 queries of 32
   tokens over 4,096 pages of up to 1,030, on their tensor-core path; also
   the store's one query, and for K1 a sweep's 120 queries, checked bit for
   bit against 120 calls of one and against the plain version on 128 pages;
   a repeated call, an odd page count and a query alone bit-identical; K1's
   CUDA-core kernel on float32 pages), K2 attention (and
   ``scaled_dot_product_attention`` on the same inputs), K3 normalize (as
   graph replays cycling over 12 input sets, the eager time beside; every
   byte value in each channel position under two statistics, a repeat
   bit-identical), K5a-c
   fused SigLIP layer / attention block / MLP block (as CUDA-graph replays,
   each of its bf16 GEMMs on ``gemm_wgmma``), the four GEMMs they are made
   of alone at M = 8,192 (QKV with LN, out_proj + residual, fc1 with LN +
   gelu, fc2 + residual: per element within 2^-7|want| + 2e-3 of
   ``gemm_reference``, plus one bf16 step of the product through gelu or
   the residual;
   with a LayerNorm, on the kernel's own normalized A, which an identity
   weight gives exactly and which must be within a bf16 step of
   ``F.layer_norm``'s;
   bit-exact on grid inputs, a repeat bit-identical; cuBLAS's bare product
   on the normalized input beside each, timed only) and the LayerNorm
   statistics pre-pass, and at gemma-3-27b's
   shapes K7a paged attention and K7b over int8 pools (window 0 and 1024, at
   phase 2's 8 slots of up to 4,096 tokens, at the paged batcher's decode
   step, 4 slots at 309-1,509 tokens, and at run (e)'s decode step, 16 slots
   of 1,024 at its first 16 prompts' lengths plus the reply so far, where
   the launch takes one block a slot and head and no combine; bf16 on K7's
   tensor-core path, float32 on its CUDA-core path; repeat bit-identical), K8a
   int8 projections and K9 group-wise int4 projections (decode rows of 8
   tokens, prefill rows of 512 and 1,504 tokens through the up and down
   projections; both exact on grid inputs, both bit-identical on a repeated
   call), K8b the int8 tied LM head; K6 window attention at ColFlor's four
   DaViT stage shapes in bf16 on its ring kernel (graph replays, a repeat
   bit-identical, ``scaled_dot_product_attention`` on the same inputs) and at
   stage 0 in float32. K2 must take its tensor-core path for bf16 with D % 8 == 0,
   its CUDA-core path for other bf16 D and its 3xTF32 path for float32, K8a
   and K9 their decode tile for M <= 16 and their prefill tile above. K1, K4,
   K7, K8 and K9 (K7-K9's decode calls
   are shorter than their Python launch) are timed as CUDA-graph replays (their eager
   per-call time printed beside), with ``torch._weight_int8pack_mm`` and
   ``torch._weight_int4pack_mm`` on the same inputs as yardsticks where this
   torch has a CUDA kernel for them, and beside the prefill rows one bf16
   ``torch.mm`` on the weight already dequantized (the cuBLAS time the
   prefill tiles race against). Then, at the shapes phase 7 gives them
   (PaliGemma's Gemma-2B: 8 query heads over 1 KV head of 256, hidden
   2,048, MLP 16,384, vocab 257,216), K7a over 4 slots of 6,144 tokens at a
   1-page and a 5-page image prompt's lengths and two text prompts', K8a on
   every decode projection and on the MLP at both image prompts' prefill
   rows, and K8b on the head, each against its plain version at the limits
   above; K8a's prefill tile on gemma-3-27b's attention and MLP projections
   at the rows of phase 8's image prompts and of its second question's tail.
   Last, K2 at the shape phase 8 gives it, Gemma-3's SigLIP-So400m at 896 px:
   5 images of 4,096 patches ``[5, 4096, 16, 72]`` (the plain version one
   image at a time, SDPA beside) at atol 5e-3, which the outputs' smaller
   scale at 4,096 keys calls for; and at phase 13's ColGranite tower, a
   batch of 8 pages of 729 patches ``[8, 729, 16, 72]``, also at 5e-3.
3. ColPali at full width, from a checkpoint: a bf16 HF-layout checkpoint of
   ``vidore/colpali-v1.3`` (the ``ColPaliForRetrieval`` tensors, 5.85 GB,
   norms at their identity, every other tensor N(0, fan_in^-0.5) from
   ``--seed``) is written under ``build/`` as 3 safetensors files by the
   script's own writer, after a check of the free disk space, and loaded
   with ``load_retriever(checkpoint_dir=)``: the load time and rate, the
   host's peak RSS growth and the device memory are printed, and 11
   parameters across the tower, projector, LM and head must equal the file's
   tensors after the converter's transposes. The model then embeds 16
   synthetic 448x448 pages, indexes them with ``colpali_qdrant``, answers 4
   queries with ``retrieve_colpali`` (one also under a ``username`` filter)
   and scores them with ``score_results``; ``prompt_prep_query(type=
   "colpali")`` on the first query must build one image prompt for each page
   ``retrieve_colpali`` finds, the pages' files in its order.
4. ColSmol at full width: ``vidore/colSmol-256M`` (random bf16 weights)
   embeds 32 synthetic 512x512 pages, indexes them with ``colpali_qdrant``
   into an exact, an int8, a pooled and an on_disk collection (the last
   saved and reopened), and answers 4 queries with ``query_points`` in each;
   it also embeds one batch through each partial fused kernel. Every bf16
   GEMM of the tower must take ``gemm_wgmma``: 4 a K5a launch (12 x 4 a
   batch), 2 a K5b or K5c, none on the CUDA cores.
5. Generation at full width: ``google/gemma-3-27b-it`` (16 of its 62 layers,
   ``GEN_DEPTH``, since phase 15 took the script past 17 minutes; random
   weights from ``--seed``) behind ``PagedContinuousBatcher`` (4 slots of
   2048 tokens, pages of 16) and ``GenerationServer`` on 127.0.0.1 answers 6
   concurrent OpenAI chat requests over HTTP (synthetic RAG-style MCQ prompts
   of 300-1,600 tokens: greedy, one streamed, one with the MCQ
   ``response_format``, two sampled with one seed), in three runs: (a) bf16
   weights and pools (K7a), (b) int8 pools (K7b), (c) int8 weights made leaf
   by leaf (K8a, K8b). Each greedy reply must equal the engine's own
   ``generate`` or first differ where the engine's top two logits are within
   0.05; the two sampled replies must agree; the MCQ reply must be a choice.
   Run (d) serves the greedy requests again from int4 weights made leaf by
   leaf (K9 on every projection; K8b on the head, whose table stays int8).
   Run (e), right after (a) on its engine, is the experiment's MCQ sweep
   through the port's own client (``generation/client``, on the standard
   library): ``PagedContinuousBatcher`` (16 slots of 1,024 tokens) behind
   the server, whose ``/health`` must answer (and must not once it stops,
   ``utils.health``); 120 synthetic questions in driver 05's wording (~0.9k
   tokens each) go out at once twice. Sweep 1, ``run_inference(...,
   use_schema=True)`` as driver 02 sends them: every reply must parse as
   ``{"answer": X}``, X in A-D, through ``parse.response_real_out``, and 8
   of them sent again one at a time must agree or differ only where the
   top two choices' logits at the scaffold are within 0.05; the server
   runs these constrained prefills one at a time (fault F4), so the peak
   memory stays near the pools'. Sweep 2, ``get_responses`` with 8 new
   tokens, greedy, through the batcher: no sentinel, 8 tokens each, 4 equal
   to ``engine.generate`` under phase 5's tie rule, K7a's tensor-core path
   launched. ``utils.housekeeping``'s stats are read after each sweep:
   the card's used memory (``mem_get_info``, the driver's count) must hold
   the allocator's reserved bytes, which hold its ``bytes_in_use``, within
   4 GiB (the CUDA context and module images), and ``bytes_limit`` must be
   the card's total memory; its peak equal to
   ``torch.cuda.max_memory_allocated()`` and its least used card 0 on one
   card only exercise the API (they read the same counters).
   Each sweep's wall time and requests/s, sweep 2's prompt and decode
   tokens/s and TTFT p50/p95, the peaks and the requests in the server at
   once are printed with the card.
6. ColFlor at full width: ``ahmed-masry/ColFlor`` (random bf16 weights)
   embeds 16 synthetic 768x768 pages, indexes them with ``colpali_qdrant``,
   answers 4 queries with ``retrieve_colpali`` (one also filtered) and scores
   them with ``score_results``; its DaViT windows run K6's ring kernel (12
   launches a forward), never K2.

7. Image-context serving at full width, right after phase 3, on its
   checkpoint's weights (reloaded; the directory is kept for phase 10 and
   deleted at the end): ``PaliGemmaEngine`` runs the retriever's own SigLIP tower and
   projector and decodes through the text engine's LM.
   ``PagedContinuousBatcher`` (4 slots of 6,144 tokens, pages of 16) serves
   two greedy image requests, one page and the 5 pages phase 3 retrieved for
   its first query, beside two text requests, all submitted at once; then
   an MCQ is scored over the 5 pages through ``next_token_logits``. Run (a)
   has bf16 LM weights, run (b) int8 weights (K8a, K8b). Each greedy reply
   must equal the isolated engine's (``PaliGemmaEngine.generate`` or
   ``GemmaDecodeEngine.generate``) or first differ where that engine's top
   two logits are within 0.05 (the gaps the engine records as it decodes,
   ``record_top2``). TTFT of each request, decode tokens/s, the
   MCQ's time and the peak memory are printed with the card, and the 5-page
   prefill split by CUDA events into tower, projector and LM.
8. The reference's whole generator, right after phase 5:
   ``google/gemma-3-27b-it`` with images at full width, its LM at phase 5's
   depth (random
   weights from ``--seed`` through ``load_gemma3_mm``; SigLIP-So400m at
   896 px, 256 soft tokens an image): the text engine and a
   ``Gemma3MMEngine`` on its LM in ``PagedContinuousBatcher`` (4 slots of
   2,048 tokens, pages of 16, prefix caching) serve a 1-image request, a
   5-image one (exp-02's top 5, synthetic 896 x 896 pages), a second
   question over the same 5 images, which must prefill only its tail
   against the shared image pages (counted among the image requests' own
   prefills), and two text requests, all submitted at
   once; then an MCQ over the 5 images through ``next_token_logits``. Run
   (a) has bf16 LM weights, run (b) int8 made leaf by leaf (K8a, K8b). The
   gates and the printout are phase 7's.

9. The dense RAG modes at full width, bf16: ``BAAI/bge-base-en-v1.5``
   (BERT-base, ``BertConfig.bge_base()``). (a) A bf16 HF ``BertModel``
   checkpoint of random values from ``--seed`` is written under ``build/``
   and loaded through ``BgeEmbeddings(checkpoint_dir=)``: no random-init
   warning, 8 leaves equal to the file's. (b) ``api.qdrant_process``
   indexes 4,096 synthetic chunks of 64-512 tokens with langchain payloads
   (every 8th a figure summary with an ``img_link``); its one
   ``embed_documents`` pass (batches of 64) is timed (chunks/s and unpadded
   tokens/s printed): unit norms within 1e-3, and on 64 chunks a cosine >=
   0.995 with a float32 forward of the same weights. (c) 95,904 synthetic
   unit vectors fill the collection to 100,000 chunks over 4 users. (d) 120
   questions, each through ``embed_query``, a search without a filter,
   ``TpuVectorStore.similarity_search_with_score(k=5)`` under the user's
   filter and ``prompt_prep_query(type="mm_RAG")`` (and ``type=""`` once):
   ms a query split into embed, search without and with the filter; the
   top-5 equal to a float32 product of the same bf16 corpus with a stable
   sort up to near-ties (gap < 1e-5), the filter keeping to the user, 16
   chunks first by their own text within 5e-2 of 1. (e)
   ``VectorClient(path).save()`` and a new ``VectorClient(path)``: 5 queries
   give the same ids and scores bit for bit. No kernel counter may rise in
   (b)-(e): BERT's attention has a key-padding mask (the plain einsum, as
   in JAX) and the search is one product and a sort.
10. PDF ingest at full width (last). ``native/src/mmpdf.cpp`` is built by
   g++ with the port's JPEG decoder (``native/jpeg``; no libjpeg). 8
   synthetic letter-size papers of 8-12 pages are written with the port's
   ``PdfWriter`` (~40 text lines a page, a 240 x 320 figure on every second
   page, every other one a JPEG, a 1400 x 1800 figure on paper 1's fourth
   page, a ruled table on every fourth) beside a 3-page scan (paper 1's
   rasters as full-page images, no text layer). (a) The port's driver
   ``create_context --skip-summaries`` with bge-base and
   ``vidore/colpali-v1.3`` (phase 3's checkpoint and a bf16 bge-base one,
   found through ``COLPALI_TPU_CKPT_DIR``: no random init may warn) and
   ``MMCP_DEVICE_PREPROCESS=1`` builds the text and multimodal
   collections, the page PNGs and the ColPali collection: every page in
   it, with (b)'s vectors within 2e-2. (b) ``api.create_document_embeddings``
   and (c) ``PipelinedEmbedder(batch_size=8).embed_pdf_dir`` embed the same
   directory on one retriever: the same records, embeddings within 2e-2.
   K2 (tensor-core path) and K3 must launch in (a)-(c). The scan goes
   through ``check_ocr`` and ``AutoOcr`` on the card in (a): its text holds
   each source page's title, and ``AutoOcr(device="cpu")``, run in a spawned
   worker process during (a), reads the same text, runs and ConvOcr words;
   ConvOcr's logits on the card are within 1e-4 of the CPU's on every glyph
   batch the CPU ran (TF32 off). Then
   every page is rasterized, uploaded and resized on the card (LANCZOS to
   ``resize_image``'s size, BICUBIC to 448) and must equal the host's int64
   resample bit for bit (checked on 8 host threads); so must every
   extracted figure's ``resize_image`` on the card, and each JPEG figure
   must decode within 2.5 levels a pixel of its source, none skipped.
   Printed: pages/s of
   (a)-(c), the driver's stages, ms a page for rasterize, upload + LANCZOS,
   PNG write (every 4th page) and BICUBIC, the OCR's ms a page (template, ConvOcr, its
   classifier's device time), the device's idle share over (c) (CUDA
   events around the forwards against the wall) and the peak memory.

Each main path (3, 4, each run of 5, 6, 7, 8, 9 and 10; run (e) a sweep at a
time; 11; each process of 12; each part of 13; each run of 14) sets every launch
counter to 0 before it runs and reads them after; each kernel of the path
must have run in it (ColPali, ColSmol and ColFlor: K1's tensor-core path,
ColSmol K4's too; ColPali, ColSmol and both runs of 7: K2's tensor-core
path; every run of phases 5, 7 and 8 and run (e)'s sweep 2: K7's tensor-core
path; both runs of 8:
K2's tensor-core path; run (c) and image runs (b): both of K8a's tiles and
K8b; run (d): both of K9's tiles; phase 9: none, every counter stays 0; phase 10: K2's
tensor-core path and K3; phase 13: (a) K2's tensor-core path at the tower's shapes and K1's
tensor-core path, (b) K5a with every GEMM on ``gemm_wgmma`` and K1, (c)
K2's tensor-core path and K1, and no K5 GEMM, K8a or K8b; phase 14: K2's and K7's
tensor-core paths in every run, K8a and K8b in the int8 runs, K9 and K8b in the int4
run). The line before the last is a JSON object with
each kernel's launches in those paths, its error against the plain version,
its time, the plain version's, its bound and, for K2, K6, K8a, K8b and K9,
the library call's (null where this torch has none); K8a and K9 have a row a
tile (``int8_matmul_kn`` / ``int4_matmul_kn`` the decode tile at 8 tokens,
``*.prefill`` the prefill tile at 512), K2 a row at the Gemma-3
tower's shape (``attention.gemma3_tower``, phase 8's launches), at ColQwen2.5's window
and full-block shapes (phase 11's) and at ColGranite's tower shape
(``attention.granite_tower``, phase 13 (a)'s square layout), the K5 GEMM a row a role
(``gemm.qkv``, ``gemm.out_proj``, ``gemm.fc1``, ``gemm.fc2``, each with
``cublas_bare_ms``) and its statistics pre-pass one (``ln_stats``). The last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result.

11. ColQwen2.5 at full width, from a checkpoint (after phase 10): a bf16
    HF-layout checkpoint of ``vidore/colqwen2.5-v0.2`` (3.75B parameters,
    7.5 GB in 4 files; norms at identity, the rest N(0, fan_in^-0.5) from
    ``--seed``) beside phase 3's, loaded by ``load_retriever(checkpoint_dir=)``
    with ten leaves compared with the file; 16 synthetic pages at the 54 x 54
    bucket (756 px) embedded in batches of 8, indexed through
    ``colpali_qdrant``, 4 queries through ``retrieve_colpali`` against
    ``score_results`` (the same top 5 up to near-ties), then 4 pages of two
    other sizes under ``dynamic_resolution`` (a group a grid). K2 must run at
    both of the tower's shapes, ``[8 * 49, 64, 16, 80]`` with ``kv_lens`` (28
    window layers) and ``[8, 3136, 16, 80]`` with ``kv_valid`` (4 full
    blocks), every launch on its tensor cores; phase 2 holds K2 at both
    against the plain version (rows ``attention.colqwen_window`` and
    ``attention.colqwen_full``, SDPA with the boolean mask beside).
12. The experiment drivers through the port's server (last): ``serve`` as a
    subprocess on phase 3's ColPali checkpoint (``PaliGemmaEngine``, the
    paged batcher); against it, each driver as a subprocess; the server and
    every driver under an import guard refusing jax, PIL, pandas and
    aiohttp, which also counts the process's kernel launches (the server's
    at its ``/stats``): ``experiment01`` on phase 10's collections (no-RAG,
    mm_RAG, colpali with a ``gpt*`` name, so the MCQ schema is sent and the
    server answers by one constrained forward; colpali again with a local
    model's name, so the server decodes), ``experiment01_run`` over the four
    modes (``--repeats 1``, 8 legs), ``experiment02 --retrievers
    vidore/colqwen2.5-v0.2 vidore/colpali-v1.3 --context`` on phase 10's
    PDFs; synthetic questions in driver 05's wording (12 of the reference's
    120; 4 a leg and for the local model). Every schema answer one of A-D,
    every colpali / --context request with its 5 images decoded in the
    server (its ``/stats``), every context reference a corpus page, the
    pickles' and CSVs' schemas; K1 in experiment01's colpali search, K2 on
    its tensor cores and K1 in experiment 02's embedding and
    ``score_results``, K2 on its tensor cores in the server's image
    forwards and K7a in its decode; experiment 02's wall split into embed /
    retrieve / encode / serve. Its launches join the kernels line.
13. The rest of the reference's retriever grid (after phase 11, while phase
    3's checkpoint exists; phase 12 stays last), three main paths each with
    its own counts. (a) ColGranite at full width:
    ``ibm-granite/granite-vision-3.3-2b-embedding`` (2.95B, random bf16
    weights from ``--seed`` made on the card): 16 synthetic 384 x 384 pages in
    batches of 8 through ``colpali_qdrant``, 4 queries through
    ``retrieve_colpali`` against ``score_results`` (the same top 5 up to
    near-ties); K2 27 launches a forward at ``[8, 729, 16, 72]`` on its
    tensor cores; then 4 pages of two aspects under ``dynamic_resolution``
    (anyres), one group a layout, each page's tokens
    ``n_image_tokens_for`` its layout; then K2 against its plain version on
    the tower's own q, k, v at each shape it ran (``[8, 729]`` square,
    ``[10, 729]`` anyres). (b) ColSmol with image splitting at
    full width (``vidore/colSmol-256M``, random bf16): 2 PDFs of 4 letter
    pages (5 sub-images, 320 image tokens a page) through
    ``PipelinedEmbedder`` and ``create_document_embeddings`` (``embed_images``
    a PDF), within 2e-2 of each other; 12 K5a launches a forward, every GEMM
    on ``gemm_wgmma``; K1 in the scores; K5a against its plain version on
    every layer's input at both batches of sub-images it ran (``[40, 1024,
    768]`` and ``[20, 1024, 768]``, atol 3e-2 + rtol 3e-2); then the same
    tower quantized (W8A8) over one page: no K5a or K5 GEMM, K2 on each
    layer, mean cosine with bf16 >= 0.98. (c) W8A8: ``vidore/colpali-v1.3``
    from phase 3's checkpoint with ``quantize="int8"`` against the same
    checkpoint in bf16 on phase 3's pages and queries, both timed alike (mean
    per-token cosine >= 0.98; each query's top-1 page bf16's, or within
    twice the other queries' largest |int8 - bf16| score of it; K2 and K1, no
    K5 GEMM, K8a or K8b); ``w8a8_dense`` at ColPali's Gemma MLP ``[8 x 1,030,
    2,048] -> 16,384``, its int32 sums equal to an exact product on the host
    (float64: these integer sums stay below 2^53), timed beside one bf16
    ``torch.mm``; Gemma-3's SigLIP-So400m at 896 px (as ``_vision_parts``
    builds it) int8 against bf16 over 5 images: the soft tokens' mean cosine
    >= 0.98. Printed: pages/s (square, anyres, ColSmol both ways, W8A8), ms
    a query, image tokens a page, peaks, the phase's wall time.
14. The old-model tier (after phase 13, before phase 12), random weights
    from ``--seed`` made on the card, behind ``GenerationServer`` on 4 slots
    of 6,144 with pages of 16. Each run sends at once two RAG text requests
    of 600 and 1,500 byte tokens whose context repeats a passage, a 1-image and
    a 5-image request (PNG data URLs decoded by the port) and an MCQ
    ``response_format`` request, 32 new tokens each; every greedy reply must
    equal the isolated engine's (``Qwen2VLMMEngine.generate`` /
    ``engine.generate``) or first differ where its top two logits are within
    0.05 (a k-row verify and a 1-row decode round differently in bf16).
    (a) ``AdaptLLM/biomed-Qwen2-VL-2B-Instruct`` at full width and depth
    (2.2B) on ``SpeculativePagedContinuousBatcher(spec_k=4)``: bf16 weights
    and KV (K2 at ``[5, 2916, 16, 80]`` on its tensor cores, 32 a 5-image
    tower; K7a over the verify's ``[16, 12, 128]`` rows on its tensor
    cores), int8 weights with int8 KV (K8a, K8b on the tied 151,936-row
    head, K7b), int4 weights (K9, K8b). (b)
    ``AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B`` at full width (8.4B, images at
    336 px, 1,176 tokens each): bf16 through the plain paged batcher (K2 at
    CLIP's ``[5, 577, 16, 64]``, 23 a tower), then speculative with int8 KV
    (K7b over ``[16, 32, 128]``), then (b2) int8 weights made leaf by leaf
    (K8a on every projection and on the untied 128,320-column head),
    speculative. Then K2 at both towers and K7a / K7b at the verify rows
    against their plain versions on the path's own tensors (rows
    ``attention.qwen2vl_tower``, ``attention.clip_tower``,
    ``paged_attention.verify``, ``paged_attention_int8.verify``). Printed a
    run: accepted tokens a verify, each request's TTFT, decode tokens/s and
    the peak; the phase's wall time.
15. Llama-3.2-11B-Vision (Mllama, after phase 14, before phase 12) at full
    width and depth (32 self and 8 gated cross layers, the 4-tile ViT-H/14
    tower; random weights from ``--seed`` made on the card) behind
    ``GenerationServer`` on 4 slots of 6,144, pages of 16, cross pools of 5
    images a slot; phase 14's requests, the MCQ over the 5 images. (a) bf16
    weights and KV, tiles 1x1, the plain paged batcher (K7a at ``[4, 32,
    128]``); (b) the speculative paged batcher (k = 4) over int8 KV (K7b
    over ``[16, 32, 128]``, the cross blocks in the verify); (c) int8 weights
    made leaf by leaf, tiles 2x2, the W8A8 tower (K8a on every self and cross
    projection and the untied head, both tiles; the prefill tile on the
    cross K/V rows ``[32,020, 4,096] -> 1,024``). Every greedy reply equals
    the isolated ``MllamaMMEngine.generate`` / ``engine.generate`` up to
    phase 5's near-ties, the MCQ answers a choice, another image changes the
    1-image request's first logits (the cross path is live) and the W8A8
    tower's mean per-token cosine with bf16's is >= 0.98. Then K7a, K7b and
    K8a against their plain versions on the path's own tensors (rows
    ``paged_attention.mllama_decode``, ``paged_attention_int8.mllama_verify``,
    ``int8_matmul_kn.mllama_cross_kv``). Printed: each request's TTFT,
    decode tokens/s and ms a step, accepted tokens a verify, the 5-image
    prefill split into tower / projector / cross K/V / LM by CUDA events,
    peaks, the phase's wall time.
16. Training (right after phase 2, on a clean card), float32, the JAX
    trainer's dtype, with TF32 off and cuDNN deterministic: (a)
    ``vidore/colpali-v1.3`` at full width and depth (2.925B, random from
    ``--seed``) takes 5 AdamW steps (``training.make_training_setup``,
    optax's defaults, lr 1e-5; ``make_train_step``) on a fixed batch of 3
    queries and 3 synthetic 448-px pages normalized as the processor does
    (2 pages peaked at 54.8 GiB, so the third fits):
    every loss and gradient finite, the last loss below the first, K2's
    forward and backward kernels (both 3xTF32) 27 launches each a step (the
    page forward's tower) and no other kernel. (b) 2 SigLIP + 2 Gemma layers
    at full width: one step with the kernels against the same step under
    ``layers.set_fused_attention(False)`` (the plain attention and its
    autograd, on the card; loss rel 1e-5, every gradient within 1e-4 of its
    leaf's largest element plus 1e-6 of the largest gradient), ``remat=True``
    against it (loss rel 1e-6), and a checkpoint saved after step 2
    (``training.checkpoint``) restored into a fresh model and optimizer,
    whose step 3 equals the uninterrupted step 3 bit for bit. (c) K2's
    float32 forward (row ``attention.training``) and its backward, both on
    the 3xTF32 path, against ``attention_reference`` (atol 1e-4) and
    ``attention_backward_reference`` (1e-4 of the largest element) at
    ``[3, 1024, 16, 72]`` and at a masked case (kv_lens, kv_valid, causal, a
    fully masked row), repeats bit-identical. Printed: step seconds (median
    of steps 2-5), tokens/s, model TFLOP/s, peak GiB, the loss per step,
    K2's times beside their float32 and 3xTF32 bounds with the registers and
    spills ptxas gave the launched instantiations, SDPA's forward and
    backward beside, the phase's wall time.
17. The scale-out at world size 1 (after phase 15, before phase 12): a
    1-rank NCCL group opened through ``parallel.initialize_distributed``
    and closed at the end; each of (a)-(c) is a main path with its own
    launch counts, and every mesh result is held against the mesh-less one.
    (a) 8,192 synthetic pages of 1,056 x 128 (2.2 GB bf16, 1.1 GB of int8
    codes on the card) in exact, int8 and pooled collections of
    ``VectorClient(mesh=)`` and ``VectorClient()``, 4 queries each, one
    filtered: equal ids, scores within K1's rtol 1e-3 (the largest
    difference printed; bit-equal expected), each mode's query ms for both;
    ``DistributedCorpusView`` over the same rows equals the single-device
    two-stage search on its own tensors. (b) ``load_retriever(
    "vidore/colSmol-256M", mesh=)`` embeds phase 4's pages bit-equal to the
    mesh-less retriever (pages/s of both). (c) gemma-3-27b at full width and
    ``SCALE["depth"]`` layers (random weights) served by
    ``PagedContinuousBatcher`` + ``GenerationServer`` over a ``("data",
    "model")`` mesh engine in bf16 (native and int8 KV pools) and int8
    weights: 4 greedy requests of 16 tokens equal the mesh-less
    ``generate`` under phase 5's tie rule (0.05); decode tokens/s beside
    the mesh-less engine's behind the same batcher (bf16). (d) The kernels at the shapes a rank of tp = 2 and 4
    gives them: K7a/K7b at 16/8 and 8/4 heads (the decode step's 4 slots,
    windows 0 and 1,024), K8a's decode and prefill tiles on the column
    slices 5,376 -> 2,048, 1,024, 10,752, 5,376 and the row slices 2,048,
    1,024, 10,752, 5,376 -> 5,376, K1/K4 on a shard of 2,048 pages and on an
    odd one, each against its plain version at phase 2's limits. (e) DP x TP
    training on a ``(data, model)`` = (1, 1) mesh, float32 (phase 16's
    numerics): at phase 16 (b)'s 2 SigLIP + 2 Gemma layers, full width, 2
    steps of ``make_training_setup(mesh=)`` / ``make_train_step(mesh=)``
    equal the mesh-less steps (losses and parameters; bit-equal expected),
    their step walls side by side in interleaved repeats; a (1, 1)
    checkpoint saved after step 2 resumes step 3 bit for bit; then the
    full-width, full-depth model takes 2 mesh steps on phase 16's batch
    (the main path: loss finite and falling, K2's forward and backward 27
    launches each a step); K2's float32 forward and backward at a rank's
    ``[3, 1024, 8, 72]`` and ``[3, 1024, 4, 72]`` (tp = 2, 4) against their
    plain versions, SDPA's times beside (``k2_training_rows``). (f), run
    after (c) on its bf16 engines: serving through the batchers' admission
    records on the (1, 1) mesh's leader path. ``Gemma3MMEngine`` over (c)'s
    mesh engine with SigLIP-So400m at 896 px (random, from ``seed``) behind
    ``PagedContinuousBatcher`` + ``GenerationServer``: a 1-image and a
    5-image request, two text requests and an MCQ over the 5 images sent at
    once through the port's client (``generation/client``); the replies
    equal the mesh-less server's under phase 5's tie rule, the records and
    the constrained forward were applied, K2 and K7a ran on their tensor
    cores; TTFT and decode tokens/s beside the mesh-less server's in
    interleaved bursts. Llama-3.2-11B-Vision cut to 8 self and 2 cross
    layers (its whole tower) behind the dense ``ContinuousBatcher`` on the
    mesh: a 2-image request equals the mesh-less one; the dense caches and
    cross pools take the mesh-less batcher's bytes, and the bytes a rank
    would hold at dp = 2 and 4 are printed (and gemma-3-27b's at 8 slots
    of 8,192, by its config).

Phases 10 and 12 (host-bound) run at half the depth they had before phase 16
was added (8 papers, 12 questions), which keeps the script within its 1,200 s.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "multimodal_colpali_tpu_torch"

K1 = dict(b=4, nq=32, dim=128, p=4096, nt=1030)
K2 = dict(b=8, s=1024, h=16, d=72)
K2_GEMMA3 = dict(b=5, s=4096, h=16, d=72)   # Gemma-3's So400m at 896 px, 5 images
# phase 11: ColQwen2.5 pages at the 54 x 54 bucket (756 px), a batch of 8,
# and pages of two other sizes under dynamic resolution
QWEN = dict(pages=16, batch=8, size=756, dyn=((1000, 700), (560, 1100)), dyn_pages=4)
# N(0, 1) inputs at scale 72^-0.5 average 4,096 values: outputs of std about
# sqrt(e / 4096) = 0.026, so K2's 2e-2 (set at 1,024 keys) would pass a kernel
# that dropped a 64-key block (max|err| about 0.017); bf16 rounding of P and
# the output stays near 2e-3 here
K2_GEMMA3_ATOL = 5e-3
# ColGranite's SigLIP-So400m at 384 px (27 x 27 patches), phase 13's batch of
# 8 pages; its outputs average 729 values (std about sqrt(e / 729) = 0.06):
# dropping a 64-key block moves them by about 0.02, bf16 rounding by ~2e-3
K2_GRANITE = dict(b=8, s=729, h=16, d=72)
K2_GRANITE_ATOL = 5e-3
# ColQwen2.5's windows average 16-64 values, so their outputs reach ~3 in
# magnitude, where one bf16 step is 2^-6. The kernel rounds P to bf16 (2^-9
# of each p) before P V and its output once more, the plain version its
# output: each element is held within 2^-7 |want| + 2^-8 (P |V|), twice
# those roundings, with P |V| the plain version on |V|, and within K2's
# general 2e-2. Its full blocks average 2,916 (as the Gemma-3 tower's
# 4,096): atol 5e-3
K2_QWEN_RTOL, K2_QWEN_PV = 2.0 ** -7, 2.0 ** -8
K3 = dict(b=8, size=448, sets=12)  # 12 x 4.8 MB of pixels: more than the 50 MB L2
K5 = dict(b=8, s=1024, h=768, heads=12, inter=3072)  # ColSmol's SigLIP layer
# gemma-3-27b: 32 q / 16 kv heads of 128, pages of 16, 8 slots of up to 4096 tokens
K7 = dict(b=8, hq=32, hkv=16, d=128, page=16, nb=256)
K8 = dict(h=5376, inter=21504, vocab=262208)   # gemma-3-27b, also K9's (group 256)
K6 = dict(n=8192, s=144, d=32)    # ColFlor stage 0 at batch 8: 8 x 256 windows x 4 heads
K6_STAGES = (8192, 4096, 2048, 1024)  # ColFlor's four DaViT stages at batch 8 (heads 4 ... 32)
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12   # H100 SXM peaks (data sheet)
TF32_FLOPS = 495e12   # dense TF32 on the tensor cores (data sheet)
N_PAGES, EMBED_BATCH, TOP_K = 16, 8, 5
SMOL_PAGES, SMOL_BATCH = 32, 16
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


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row(err, ms, plain_ms, nbytes, flops, peak=BF16_FLOPS, library_ms=None):
    bound_ms, by = bound(nbytes, flops, peak)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=library_ms)


def library_op(torch, name: str):
    """``torch.<name>`` when this torch registers a CUDA kernel for
    ``aten::<name>``, else None (printed): a yardstick, timed only."""
    if torch._C._dispatch_has_kernel_for_dispatch_key(f"aten::{name}", "CUDA"):
        return getattr(torch, name)
    print(f"[kernels] aten::{name}: none on this torch (no CUDA kernel)", flush=True)
    return None


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
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | build: nvcc "
          f"{nvcc_s:.1f} s ({', '.join(sorted(libs))}) | ptxas: {ptxas_summary(libs)}",
          flush=True)
    return card


def phase_kernels(torch, seed: int):
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    # K1: MaxSim at [4, 32, 128] x [4096, 1030, 128] bf16, ragged pages, some empty
    c = K1
    q32 = F.normalize(torch.randn(c["b"], c["nq"], c["dim"], generator=g, device=dev), dim=-1)
    q = q32.to(torch.bfloat16)
    d = torch.empty(c["p"], c["nt"], c["dim"], dtype=torch.bfloat16, device=dev)
    for s in range(0, c["p"], 512):
        part = torch.randn(min(512, c["p"] - s), c["nt"], c["dim"], generator=g, device=dev)
        d[s: s + 512] = F.normalize(part, dim=-1).to(torch.bfloat16)
    q_lens = torch.tensor([c["nq"], 20, 1, c["nq"]], dtype=torch.int32, device=dev)
    d_lens = torch.randint(1, c["nt"] + 1, (c["p"],), generator=g, device=dev, dtype=torch.int32)
    d_lens[::97] = 0
    tc = M.maxsim_scores_cuda.tensor_core_launches
    got = M.maxsim_scores_cuda(q, d, q_lens, d_lens)
    require(M.maxsim_scores_cuda.tensor_core_launches == tc + 1,
            "K1: bf16 with DIM % 16 == 0 did not take the tensor-core path")
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
    # bit for bit: a repeated call, an odd page count, a query alone
    odd = c["p"] - 3
    require(torch.equal(M.maxsim_scores_cuda(q, d, q_lens, d_lens), got),
            "K1: a repeated call differs")
    require(torch.equal(M.maxsim_scores_cuda(q, d[:odd], q_lens, d_lens[:odd]), got[:, :odd]),
            "K1: an odd page count differs")
    require(torch.equal(M.maxsim_scores_cuda(q[1:2], d, q_lens[1:2], d_lens), got[1:2]),
            "K1: a query alone (B = 1) differs from its row of the batch")
    k_ms, p_ms = timed_pair(torch, lambda: M.maxsim_scores_cuda(q, d, q_lens, d_lens),
                            lambda: M.maxsim_scores_reference(q, d, q_lens, d_lens), iters=5)
    g_ms = graph_ms(lambda: M.maxsim_scores_cuda(q, d, q_lens, d_lens), iters=20)
    live_d = float(d_lens.sum())   # the tokens this data needs

    def k1_bytes(qq, out):
        return live_d * c["dim"] * 2 + qq.numel() * 2 + out.numel() * 4

    results["maxsim"] = row(k1_err, g_ms, p_ms, k1_bytes(q, got),
                            2.0 * c["dim"] * float(q_lens.sum()) * live_d)
    top_same = bool((ki == pi).all())
    print(f"[kernels] K1 maxsim {list(q.shape)}x{list(d.shape)} bf16: max|err| {k1_err:.3g} "
          f"(rtol 1e-3), empty pages exact, top-5 {'identical' if top_same else 'equal up to ties'}"
          f", repeat / odd page count / B = 1 bit-identical | graph replay {g_ms:.4f} ms (eager "
          f"{k_ms:.4f}), plain {p_ms:.3f} ms, bound {results['maxsim']['bound_ms']:.4f} ms",
          flush=True)
    del want
    torch.cuda.empty_cache()

    # K1 at the store's one query (B = 1) and a sweep's 120 queries, same corpus
    g2 = torch.Generator(device=dev).manual_seed(seed + 1)
    q120 = F.normalize(torch.randn(120, c["nq"], c["dim"], generator=g2, device=dev),
                       dim=-1).to(torch.bfloat16)
    lens1, lens120 = q_lens[:1], torch.full((120,), c["nq"], dtype=torch.int32, device=dev)
    one = M.maxsim_scores_cuda(q[:1], d, lens1, d_lens)
    require(torch.equal(one, got[:1]), "K1: B = 1 differs from its row of the batch")
    b1_ms = graph_ms(lambda: M.maxsim_scores_cuda(q[:1], d, lens1, d_lens), iters=20)
    b1_bound, _ = bound(k1_bytes(q[:1], one), 2.0 * c["dim"] * c["nq"] * live_d)
    launches = M.maxsim_scores_cuda.launches
    sweep = M.maxsim_scores_cuda(q120, d, lens120, d_lens)
    n_launch = M.maxsim_scores_cuda.launches - launches
    stacked = torch.cat([M.maxsim_scores_cuda(q120[i: i + 1], d, lens120[:1], d_lens)
                         for i in range(120)])
    require(torch.equal(sweep, stacked), "K1: 120 queries differ from 120 calls of one")
    head = M.maxsim_scores_reference(q120, d[:128], lens120, d_lens[:128])
    live_h = d_lens[:128] > 0
    require(torch.allclose(sweep[:, :128][:, live_h], head[:, live_h], rtol=1e-3, atol=1e-3),
            "K1: 120 queries differ from the plain version on the first 128 pages")
    b120_ms = graph_ms(lambda: M.maxsim_scores_cuda(q120, d, lens120, d_lens), iters=5)
    b120_bound, b120_by = bound(k1_bytes(q120, sweep), 2.0 * c["dim"] * 120 * c["nq"] * live_d)
    reads_ms = n_launch * live_d * c["dim"] * 2 / HBM_BPS * 1e3
    print(f"[kernels] K1 maxsim B = 1: graph replay {b1_ms:.4f} ms, bound {b1_bound:.4f} ms | "
          f"B = 120 ({n_launch} launches of {M.ROWS_PER_LAUNCH} rows): graph replay "
          f"{b120_ms:.3f} ms, bound {b120_bound:.3f} ms ({b120_by}; the corpus read once a "
          f"launch: {reads_ms:.3f} ms), bit for bit 120 calls of one, plain on 128 pages "
          f"within rtol 1e-3", flush=True)
    del sweep, stacked, head, q120
    torch.cuda.empty_cache()

    # K1's CUDA-core kernel: float32 pages (the tensor-core one takes bf16)
    d32 = d[:256].float()
    cc = M.maxsim_scores_cuda.cuda_core_launches
    got32 = M.maxsim_scores_cuda(q32, d32, q_lens, d_lens[:256])
    require(M.maxsim_scores_cuda.cuda_core_launches == cc + 1,
            "K1: float32 pages did not take the CUDA-core kernel")
    want32 = M.maxsim_scores_reference(q32, d32, q_lens, d_lens[:256])
    live32 = live[:256]
    require(torch.allclose(got32[:, live32], want32[:, live32], rtol=1e-4, atol=1e-4),
            "K1: the float32 CUDA-core kernel differs from the plain version")
    print(f"[kernels] K1 maxsim float32 {list(q32.shape)}x{list(d32.shape)} on the CUDA-core "
          f"kernel: max|err| {float((got32 - want32)[:, live32].abs().max()):.3g} (rtol 1e-4)",
          flush=True)
    del d32, got32, want32, got
    torch.cuda.empty_cache()

    # K4: float32 queries against the same corpus quantized to int8 codes + scales
    codes, scales = M.quantize_corpus_int8(d)
    del d
    torch.cuda.empty_cache()
    tc = M.maxsim_scores_int8_cuda.tensor_core_launches
    got = M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens, d_lens)
    require(M.maxsim_scores_int8_cuda.tensor_core_launches == tc + 1,
            "K4: int8 codes with DIM % 16 == 0 did not take the tensor-core path")
    want = M.maxsim_scores_int8_reference(q32, codes, scales, q_lens, d_lens)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "K4: non-finite score")
    require(torch.allclose(got[:, live], want[:, live], rtol=1e-4, atol=0),
            "K4: scores differ from the plain version beyond rtol 1e-4")
    require(torch.allclose(got[:, ~live].double(), empty_want.expand(-1, int((~live).sum())),
                           rtol=1e-6, atol=0), "K4: empty pages do not score -q_len * 1e30")
    k4_err = float((got[:, live] - want[:, live]).abs().max())
    kv, ki = topk_with_stable_ties(got, 5)
    pv, pi = topk_with_stable_ties(want, 5)
    gap = (want.gather(1, ki.long()) - pv).abs()
    require(bool((gap <= 1e-4 * pv.abs()).all()),
            "K4: top-5 differs from the plain version beyond near-ties")
    require(torch.equal(M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens, d_lens), got),
            "K4: a repeated call differs")
    require(torch.equal(M.maxsim_scores_int8_cuda(q32, codes[:odd], scales[:odd], q_lens,
                                                  d_lens[:odd]), got[:, :odd]),
            "K4: an odd page count differs")
    one = M.maxsim_scores_int8_cuda(q32[:1], codes, scales, lens1, d_lens)
    require(torch.equal(one, got[:1]), "K4: B = 1 differs from its row of the batch")
    k_ms, p_ms = timed_pair(torch, lambda: M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens,
                                                                     d_lens),
                            lambda: M.maxsim_scores_int8_reference(q32, codes, scales, q_lens,
                                                                   d_lens), iters=5)
    g_ms = graph_ms(lambda: M.maxsim_scores_int8_cuda(q32, codes, scales, q_lens, d_lens),
                    iters=20)
    b1_ms = graph_ms(lambda: M.maxsim_scores_int8_cuda(q32[:1], codes, scales, lens1, d_lens),
                     iters=20)

    def k4_bytes(qq, out):
        return live_d * (c["dim"] + 4) + qq.numel() * 4 + out.numel() * 4

    results["maxsim_int8"] = row(k4_err, g_ms, p_ms, k4_bytes(q32, got),
                                 2.0 * c["dim"] * float(q_lens.sum()) * live_d)
    b1_bound, _ = bound(k4_bytes(q32[:1], one), 2.0 * c["dim"] * c["nq"] * live_d)
    top_same = bool((ki == pi).all())
    print(f"[kernels] K4 maxsim_int8 {list(q32.shape)} f32 x {list(codes.shape)} int8 + scales: "
          f"max|err| {k4_err:.3g} (rtol 1e-4), empty pages exact, top-5 "
          f"{'identical' if top_same else 'equal up to near-ties'}, repeat / odd page count / "
          f"B = 1 bit-identical | graph replay {g_ms:.4f} ms (eager {k_ms:.4f}), plain "
          f"{p_ms:.3f} ms, bound {results['maxsim_int8']['bound_ms']:.4f} ms | B = 1: graph "
          f"replay {b1_ms:.4f} ms, bound {b1_bound:.4f} ms", flush=True)
    del codes, scales, got, want, one
    torch.cuda.empty_cache()

    # K2: SigLIP-So400m self-attention [8, 1024, 16, 72] bf16, plus masked cases
    c = K2
    shape = (c["b"], c["s"], c["h"], c["d"])
    qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    scale = c["d"] ** -0.5
    tc = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(*qkv, scale=scale)
    require(A.fused_attention_cuda.tensor_core_launches == tc + 1,
            "K2: bf16 with D % 8 == 0 did not take the tensor-core path")
    want = A.attention_reference(*qkv, scale=scale)
    k2_err = float((got.float() - want.float()).abs().max())
    require(k2_err <= 2e-2, f"K2: max|err| {k2_err} > 2e-2")
    # small masked cases: float32 (3xTF32 tensor cores), bf16 D = 24 (tensor cores), D = 20
    # (CUDA cores)
    for dtype, d, atol, path in ((torch.float32, 24, 1e-4, "tf32"),
                                 (torch.bfloat16, 24, 2e-2, "tensor_core"),
                                 (torch.bfloat16, 20, 2e-2, "cuda_core")):
        sq = [torch.randn((2, 40, 3, d), generator=g, device=dev).to(dtype) for _ in range(3)]
        lens = torch.tensor([40, 17], dtype=torch.int32, device=dev)
        valid = torch.rand(2, 40, generator=g, device=dev) > 0.4
        valid[1] = False  # a row with every key masked: uniform weights
        for kw in (dict(kv_lens=lens), dict(kv_valid=valid), dict(causal=True),
                   dict(kv_lens=lens, kv_valid=valid, causal=True)):
            tc = getattr(A.fused_attention_cuda, f"{path}_launches")
            a = A.fused_attention_cuda(*sq, scale=0.2, **kw)
            require(getattr(A.fused_attention_cuda, f"{path}_launches") == tc + 1,
                    f"K2 small case {dtype} D={d} did not take its {path} path")
            b = A.attention_reference(*sq, scale=0.2, **kw)
            err = float((a.float() - b.float()).abs().max())
            require(err <= atol, f"K2 small case {dtype} D={d} {sorted(kw)}: max|err| {err} > "
                                 f"{atol}")
    k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(*qkv, scale=scale),
                            lambda: A.attention_reference(*qkv, scale=scale), iters=10)
    # the library call: scaled_dot_product_attention on the same tensors, [B, H, S, D] views
    qt, kt, vt = (x.transpose(1, 2) for x in qkv)
    lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                      iters=10)
    results["attention"] = row(k2_err, k_ms, p_ms, 4 * qkv[0].numel() * 2,
                               4.0 * c["b"] * c["h"] * c["s"] ** 2 * c["d"], library_ms=lib_ms)
    r = results["attention"]
    print(f"[kernels] K2 attention {list(shape)} bf16 (tensor cores, "
          f"{A.block_rows(torch.bfloat16, c['s'], c['d'])}-row blocks): max|err| {k2_err:.3g} "
          f"(atol 2e-2); kv_lens/kv_valid/causal cases pass on both paths | kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})", flush=True)
    del qkv, got, want
    torch.cuda.empty_cache()

    results.update(normalize_kernel(torch, g))
    results.update(fused_layer_kernels(torch, g))
    results.update(window_attention_kernel(torch, g))
    results.update(generation_kernels(torch, g, seed))
    paligemma_kernels(torch, g, results)
    gemma3_prefill_kernels(torch, g)
    # its own generator: the inputs drawn from g above stay as they were
    g3 = torch.Generator(device=dev).manual_seed(seed + 3)
    results.update(gemma3_tower_attention(torch, g3))
    results.update(granite_tower_attention(torch, g3))
    results.update(colqwen_attention_kernels(torch, g3))
    return results


def gemma3_tower_attention(torch, g):
    """K2 at the shape phase 8 gives it: Gemma-3's SigLIP-So400m at 896 px,
    5 images (exp-02's top 5) of 4,096 patches, ``[5, 4096, 16, 72]`` bf16,
    no mask (``tower_attention``)."""
    return {"attention.gemma3_tower": tower_attention(torch, g, K2_GEMMA3, K2_GEMMA3_ATOL,
                                                      "the Gemma-3 tower's shape")}


def granite_tower_attention(torch, g):
    """K2 at the shape phase 13 (a) gives it: ColGranite's SigLIP-So400m at
    384 px, a batch of 8 pages of 729 patches, ``[8, 729, 16, 72]`` bf16, no
    mask (``tower_attention``)."""
    return {"attention.granite_tower": tower_attention(torch, g, K2_GRANITE, K2_GRANITE_ATOL,
                                                       "ColGranite's tower shape")}


def tower_attention(torch, g, c: dict, atol: float, label: str) -> dict:
    """K2 at a SigLIP tower's shape ``c`` (bf16, no mask) -> its kernels row.
    The plain version runs one image at a time (at 4,096 patches its float32
    scores are 1 GiB an image); the kernel must take its tensor-core path,
    stay within ``atol`` and repeat bit for bit. SDPA on the same tensors
    beside."""
    from multimodal_colpali_tpu_torch._timing import eager_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    shape = (c["b"], c["s"], c["h"], c["d"])
    qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    scale = c["d"] ** -0.5
    tc = A.fused_attention_cuda.tensor_core_launches
    got = A.fused_attention_cuda(*qkv, scale=scale)
    require(A.fused_attention_cuda.tensor_core_launches == tc + 1,
            f"K2 at {label} did not take the tensor-core path")

    def plain():
        return torch.cat([A.attention_reference(*(x[i: i + 1] for x in qkv), scale=scale)
                          for i in range(c["b"])])

    want = plain()
    err = float((got.float() - want.float()).abs().max())
    require(err <= atol, f"K2 at [{', '.join(map(str, shape))}]: max|err| {err} > {atol}")
    require(torch.equal(A.fused_attention_cuda(*qkv, scale=scale), got),
            f"K2 at {label}: a repeated call differs")
    del want
    torch.cuda.empty_cache()
    iters = 3 if c["s"] >= 4096 else 10
    k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(*qkv, scale=scale), plain,
                            iters=iters)
    qt, kt, vt = (x.transpose(1, 2) for x in qkv)
    lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                      iters=iters + 2)
    r = row(err, k_ms, p_ms, 4 * qkv[0].numel() * 2,
            4.0 * c["b"] * c["h"] * c["s"] ** 2 * c["d"], library_ms=lib_ms)
    print(f"[kernels] K2 attention at {label} {list(shape)} bf16 (tensor "
          f"cores, {A.block_rows(torch.bfloat16, c['s'], c['d'])}-row blocks): max|err| "
          f"{err:.3g} (atol {atol}), repeat bit-identical | kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms (one image at a time), scaled_dot_product_attention {lib_ms:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
          f"{4.0 * c['b'] * c['h'] * c['s'] ** 2 * c['d'] / k_ms / 1e9:.1f} TFLOP/s", flush=True)
    del qkv, got
    torch.cuda.empty_cache()
    return r


def colqwen_attention_kernels(torch, g):
    """K2 at the two shapes ColQwen2.5's tower gives it at the 54 x 54 bucket,
    batch ``QWEN["batch"]``: its 49 windows of up to 64 patches folded into
    the batch, ``[8 * 49, 64, 16, 80]`` with each window's ``kv_lens`` (the
    edge windows hold 32 or 16 real patches), and its full blocks over the
    padded sequence, ``[8, 3136, 16, 80]`` with ``kv_valid`` (2,916 real
    keys). Each on the tensor-core path, the windows within 2^-7 |want| +
    2^-8 (P |V|) of the plain version an element, the full blocks within 5e-3 (the
    plain version (the full blocks' one image at a time), a repeat bit for
    bit; ``scaled_dot_product_attention`` with the equivalent boolean
    ``attn_mask`` beside, timed only. The bound counts the keys each row
    attends."""
    from multimodal_colpali_tpu_torch._timing import eager_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.models.configs import ColQwen2ModelConfig
    from multimodal_colpali_tpu_torch.models.qwen2vl import window_layout
    from multimodal_colpali_tpu_torch.ops import attention as A

    cfg = ColQwen2ModelConfig.colqwen2_5_v0_2()
    v, b = cfg.vision, QWEN["batch"]
    lay = window_layout(v, cfg.grid_h, cfg.grid_w)
    n_win, w = lay["win"]
    dev = torch.device("cuda")
    lens = torch.from_numpy(lay["win_lens"]).to(dev).repeat(b)
    valid = torch.from_numpy(lay["full_valid"]).to(dev)[None].expand(b, -1).contiguous()
    s_full = valid.shape[1]
    scale = v.head_dim ** -0.5
    out = {}
    for tag, shape, kw in (("window", (b * n_win, w, v.num_heads, v.head_dim), {"kv_lens": lens}),
                           ("full", (b, s_full, v.num_heads, v.head_dim), {"kv_valid": valid})):
        qkv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
        tc = A.fused_attention_cuda.tensor_core_launches
        got = A.fused_attention_cuda(*qkv, scale=scale, **kw)
        require(A.fused_attention_cuda.tensor_core_launches == tc + 1,
                f"K2 at ColQwen2.5's {tag} shape did not take the tensor-core path")
        step = 64 if tag == "window" else 1

        def plain(q_, k_, v_):
            return torch.cat([A.attention_reference(
                q_[i: i + step], k_[i: i + step], v_[i: i + step], scale=scale,
                **{k: t[i: i + step] for k, t in kw.items()}) for i in range(0, shape[0], step)])

        want = plain(*qkv)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if tag == "window":
            pv = plain(qkv[0], qkv[1], qkv[2].abs()).float()
            excess = float((diff - K2_QWEN_RTOL * want.float().abs() - K2_QWEN_PV * pv).max())
            del pv
            limit = (f"max(|err| - 2^-7|want| - 2^-8 P|V|) {excess:.3g} (limit 0; max|err| "
                     f"limit 2e-2)")
            require(excess <= 0 and err <= 2e-2,
                    f"K2 at ColQwen2.5's window shape {list(shape)}: max|err| {err}, {limit}")
        else:
            limit = f"atol {K2_GEMMA3_ATOL}"
            require(err <= K2_GEMMA3_ATOL, f"K2 at ColQwen2.5's full shape {list(shape)}: "
                                           f"max|err| {err} > {K2_GEMMA3_ATOL}")
        del diff
        require(torch.equal(A.fused_attention_cuda(*qkv, scale=scale, **kw), got),
                f"K2 at ColQwen2.5's {tag} shape: a repeated call differs")
        del want
        torch.cuda.empty_cache()
        k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(*qkv, scale=scale, **kw),
                                lambda: plain(*qkv), iters=3)
        keys = (torch.arange(shape[1], device=dev)[None] < lens[:, None] if tag == "window"
                else valid.bool())
        qt, kt, vt = (x.transpose(1, 2) for x in qkv)
        mask = keys[:, None, None, :]
        lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                 scale=scale), iters=5)
        flops = 4.0 * v.num_heads * v.head_dim * shape[1] * float(keys.sum())
        r = row(err, k_ms, p_ms, 4 * qkv[0].numel() * 2 + keys.numel() * 4, flops,
                library_ms=lib_ms)
        print(f"[kernels] K2 attention at ColQwen2.5's {tag} shape {list(shape)} bf16 with "
              f"{next(iter(kw))} (tensor cores, {A.block_rows(torch.bfloat16, shape[1], shape[3])}"
              f"-row blocks): max|err| {err:.3g}, {limit}, repeat bit-identical | "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, scaled_dot_product_attention with "
              f"the boolean mask {lib_ms:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}), {flops / k_ms / 1e9:.1f} TFLOP/s", flush=True)
        out[f"attention.colqwen_{tag}"] = r
        del qkv, got
        torch.cuda.empty_cache()
    return out


def normalize_kernel(torch, g):
    """K3 at [8, 448, 448, 3]: within one bf16 ulp of the plain version, also
    for every byte value in each channel position under (0.5, 0.5, 0.5) and
    ImageNet's statistics; a repeat bit-identical; graph replays cycling
    over 12 input sets (57.8 MB of pixels alone, past the 50 MB L2), eager
    beside."""
    from multimodal_colpali_tpu_torch._timing import cycle, graph_ms
    from multimodal_colpali_tpu_torch.ops import preprocess as PP

    c, dev = K3, torch.device("cuda")
    xs = [torch.randint(0, 256, (c["b"], c["size"], c["size"], 3), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8) for _ in range(c["sets"])]
    x, mean, std = xs[0], (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    got = PP.normalize_images_cuda(x, mean, std)
    want = PP.normalize_images_reference(x, mean, std)
    ulps = int(bf16_ulps(torch, got, want).max())
    require(ulps <= 1, f"K3: {ulps} bf16 ulps from the plain version (limit 1)")
    require(torch.equal(PP.normalize_images_cuda(x, mean, std).view(torch.int16),
                        got.view(torch.int16)), "K3: a repeated call is not bit-identical")
    table = torch.arange(256, device=dev, dtype=torch.uint8)[None, :, None, None].expand(
        1, 256, 1, 3).contiguous()
    for m, s in ((mean, std), ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))):
        t_ulps = int(bf16_ulps(torch, PP.normalize_images_cuda(table, m, s),
                               PP.normalize_images_reference(table, m, s)).max())
        require(t_ulps <= 1, f"K3: {t_ulps} bf16 ulps on the byte table under {m}, {s}")
    k3_err = float((got.float() - want.float()).abs().max())
    k_ms = graph_ms(cycle([lambda x=x: PP.normalize_images_cuda(x, mean, std) for x in xs]), 20)
    eager, p_ms = timed_pair(torch, lambda: PP.normalize_images_cuda(x, mean, std),
                             lambda: PP.normalize_images_reference(x, mean, std), iters=20)
    r = row(k3_err, k_ms, p_ms, 3 * x.numel(), 2.0 * x.numel(), F32_FLOPS)
    r["eager_ms"] = eager
    print(f"[kernels] K3 normalize {list(x.shape)} u8->bf16: max {ulps} ulp, byte table "
          f"within 1 ulp under both statistics, repeat bit-identical, max|err| {k3_err:.3g} | "
          f"kernel {k_ms:.4f} ms (graph, {c['sets']} input sets), eager {eager:.4f} ms, plain "
          f"{p_ms:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return {"normalize": r}


def window_attention_kernel(torch, g):
    """K6 at ColFlor's four DaViT stage shapes in bf16 (the ring kernel; graph
    replays, a repeat bit-identical) and at stage 0 in float32."""
    from multimodal_colpali_tpu_torch._timing import graph_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    dev = torch.device("cuda")
    s, d = K6["s"], K6["d"]
    scale = d ** -0.5
    qkv = [torch.randn((K6["n"], s, d), generator=g, device=dev) for _ in range(3)]
    got = WA.window_attention_cuda(*qkv, scale=scale)
    want = WA.window_attention_reference(*qkv, scale=scale)
    f32_err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
            f"K6 float32: max|err| {f32_err} beyond atol and rtol 1e-5")
    del qkv, got, want
    grid = WA.ring_grid()
    r, lines = None, []
    for stage, n in enumerate(K6_STAGES):
        qkv = [torch.randn((n, s, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3)]
        ring = WA.window_attention_cuda.ring_launches
        got = WA.window_attention_cuda(*qkv, scale=scale)
        require(WA.window_attention_cuda.ring_launches == ring + 1,
                f"K6 [{n},{s},{d}] bf16 did not take the ring kernel")
        want = WA.window_attention_reference(*qkv, scale=scale)
        torch.cuda.synchronize()
        require(got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all()),
                f"K6 [{n},{s},{d}]: wrong dtype or non-finite output")
        err = float((got.float() - want.float()).abs().max())
        require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
                f"K6 [{n},{s},{d}] bf16: max|err| {err} beyond atol and rtol 2e-2")
        require(torch.equal(WA.window_attention_cuda(*qkv, scale=scale).view(torch.int16),
                            got.view(torch.int16)),
                f"K6 [{n},{s},{d}]: a repeated call is not bit-identical")
        k_ms = graph_ms(lambda: WA.window_attention_cuda(*qkv, scale=scale), 20)
        # the library call: scaled_dot_product_attention on the same tensors as [N, 1, S, D]
        qt, kt, vt = (x[:, None] for x in qkv)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20)
        nbytes = 4 * qkv[0].numel() * 2
        if stage == 0:
            _, p_ms = timed_pair(torch, lambda: WA.window_attention_cuda(*qkv, scale=scale),
                                 lambda: WA.window_attention_reference(*qkv, scale=scale),
                                 iters=10)
            r = row(err, k_ms, p_ms, nbytes, 4.0 * n * s * s * d, library_ms=lib_ms)
            r["f32_max_abs_err"] = f32_err
            r["stages_ms"] = []
        r["stages_ms"].append(k_ms)
        lines.append(f"[{n},{s},{d}] {k_ms:.4f} ms ({nbytes / k_ms * 1e-9:.2f} TB/s, bound "
                     f"{bound(nbytes, 0)[0]:.4f}), sdpa {lib_ms:.4f}, max|err| {err:.3g}")
        del qkv, qt, kt, vt, got, want
        torch.cuda.empty_cache()
    print(f"[kernels] K6 window_attention bf16 on the ring kernel (grid {grid}), atol + rtol "
          f"2e-2, repeat bit-identical; float32 [{K6['n']},{s},{d}] max|err| {f32_err:.3g} "
          f"(1e-5) | plain {r['plain_ms']:.3f} ms | graph replays by stage: "
          + "; ".join(lines), flush=True)
    return {"window_attention": r}


def epilogue_step(torch, product, epilogue):
    """One bf16 step of ``product`` (the spacing of bf16 values at its
    magnitude) passed through the epilogue: times 1 for the residual, times
    gelu_tanh's slope at that element for gelu."""
    p = product.float()
    step = torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8) * (p != 0)
    if epilogue == "residual":
        return step
    beta, kappa = 0.7978845608028654, 0.044715
    t = torch.tanh(beta * (p + kappa * p ** 3))
    slope = 0.5 * (1 + t) + 0.5 * p * (1 - t * t) * beta * (1 + 3 * kappa * p * p)
    return step * slope.abs()


def gemm_bound_close(torch, got, want, product=None, epilogue="bias"):
    """(ok, max excess): per element within 2^-7|want| + 2e-3, plus, for
    gelu and the residual, which act on the product already rounded to bf16,
    one bf16 step of the product through the epilogue (tests/test_torch_cuda.py's
    bound)."""
    err = (got.float() - want.float()).abs()
    lim = 2.0 ** -7 * want.float().abs() + 2e-3
    if product is not None:
        lim = lim + epilogue_step(torch, product, epilogue)
    return bool((err <= lim).all()), float((err - lim).max())


def grid_gemm_case(torch, g, m, k, nseg, segs, ln, epilogue):
    """A GEMM's operands on a grid: small integers at power-of-two scales,
    so every float32 sum is exact in any order. LayerNorm rows are mean ± c
    with c a power of two (eps 0): each normalizes to sign · g + b exactly,
    returned as the last item (None without a LayerNorm); F.layer_norm's own
    rounding can leave ~1e-8 where that is 0, so the plain version is taken
    on the exact normalized rows."""
    dev = torch.device("cuda")

    def grid(*shape, lo=-4, hi=5, scale=1.0):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float() * scale

    kw, xn = {}, None
    if ln:
        sign = torch.ones(m, k, device=dev)
        sign[:, 1::2] = -1.0
        sign = sign[:, torch.randperm(k, generator=g, device=dev)]
        c = 2.0 ** torch.randint(-2, 3, (m, 1), generator=g, device=dev).float()
        a = grid(m, 1, scale=0.5) + c * sign
        kw.update(ln=(grid(k, lo=1, hi=4, scale=0.5), grid(k, scale=0.25)), eps=0.0)
        xn = (sign * kw["ln"][0] + kw["ln"][1]).to(torch.bfloat16)
    else:
        a = grid(m, k, scale=0.25)
    ws = [grid(nseg, k, scale=0.125).to(torch.bfloat16) for _ in range(segs)]
    bs = [grid(nseg, scale=0.0625) for _ in range(segs)]
    if epilogue == "residual":
        kw["resid"] = grid(m, nseg, scale=0.5).to(torch.bfloat16)
    return a.to(torch.bfloat16), ws, bs, kw, xn


def fused_layer_kernels(torch, g):
    """K5a-c at ColSmol's SigLIP layer with seeded random bf16 weights, then
    the four GEMMs they are made of and the LayerNorm statistics launch,
    each alone at M = 8,192, against their plain versions."""
    from multimodal_colpali_tpu_torch._timing import graph_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL

    c = K5
    dev = torch.device("cuda")
    h, inter = c["h"], c["inter"]

    def w(o, i):
        return (torch.randn(o, i, generator=g, device=dev) * i ** -0.5).to(torch.bfloat16)

    def v(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).to(torch.bfloat16)

    ln1, attn = [v(h, 1.0), v(h)], [w(h, h), v(h), w(h, h), v(h), w(h, h), v(h), w(h, h), v(h)]
    ln2, mlp = [v(h, 1.0), v(h)], [w(inter, h), v(inter), w(h, inter), v(h)]
    x = torch.randn(c["b"], c["s"], h, generator=g, device=dev).to(torch.bfloat16)
    heads = dict(heads=c["heads"])
    cases = {
        "vit_layer": ("K5a", FL.fused_vit_layer_cuda, FL.fused_vit_layer_reference,
                      ln1 + attn + ln2 + mlp, heads),
        "attn_block": ("K5b", FL.fused_vit_attention_block_cuda,
                       FL.fused_vit_attention_block_reference, ln1 + attn, heads),
        "mlp_block": ("K5c", FL.fused_mlp_block_cuda, FL.fused_mlp_block_reference,
                      ln2 + mlp, {}),
    }
    results = {}
    m = c["b"] * c["s"]
    for name, (tag, kernel, plain, args, kw) in cases.items():
        wg = FL.fused_gemm_cuda.wgmma_launches
        got = kernel(x, *args, **kw)
        want = plain(x, *args, **kw)
        torch.cuda.synchronize()
        require(FL.fused_gemm_cuda.wgmma_launches == wg + (4 if name == "vit_layer" else 2),
                f"{tag}: its GEMMs did not all take gemm_wgmma")
        require(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        # tests/test_fused_layer.py's tolerance: bf16 intermediates may round apart
        require(torch.allclose(got.float(), want.float(), rtol=3e-2, atol=3e-2),
                f"{tag}: max|err| {err} beyond atol 3e-2 + rtol 3e-2")
        e_ms, p_ms = timed_pair(torch, lambda: kernel(x, *args, **kw),
                                lambda: plain(x, *args, **kw), iters=10)
        k_ms = graph_ms(lambda: kernel(x, *args, **kw), iters=10)
        attn_flops = 2.0 * m * h * 4 * h + 4.0 * c["b"] * c["s"] ** 2 * h
        mlp_flops = 4.0 * m * h * inter
        flops = {"vit_layer": attn_flops + mlp_flops, "attn_block": attn_flops,
                 "mlp_block": mlp_flops}[name]
        results[name] = row(err, k_ms, p_ms, sum(a.numel() * a.element_size() for a in args)
                            + 2 * x.numel() * 2, flops)
        print(f"[kernels] {tag} {name} {list(x.shape)} bf16 I={inter} {c['heads']} heads: "
              f"max|err| {err:.3g} (atol 3e-2 + rtol 3e-2) | kernel {k_ms:.4f} ms (CUDA graph; "
              f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, bound "
              f"{results[name]['bound_ms']:.4f} ms", flush=True)
        del got, want

    # the four GEMMs alone: rows M = 8,192 of phase 2's x (fc2 on a gelu-shaped hidden)
    x2d = x.view(m, h)
    hid = F.gelu(torch.randn(m, inter, generator=g, device=dev), approximate="tanh").to(
        torch.bfloat16)
    gemms = {
        "qkv": (x2d, attn[0:6:2], attn[1:6:2], "bias", dict(ln=tuple(ln1), eps=1e-6)),
        "out_proj": (x2d, [attn[6]], [attn[7]], "residual", dict(resid=x2d)),
        "fc1": (x2d, [mlp[0]], [mlp[1]], "gelu", dict(ln=tuple(ln2), eps=1e-6)),
        "fc2": (hid, [mlp[2]], [mlp[3]], "residual", dict(resid=x2d)),
    }
    for role, (a, ws, bs, epi, kw) in gemms.items():
        tag = f"GEMM {role}"
        k, nseg, segs = a.shape[1], ws[0].shape[0], len(ws)
        wg = FL.fused_gemm_cuda.wgmma_launches
        got = FL.fused_gemm_cuda(a, ws, bs, epi, **kw)
        require(FL.fused_gemm_cuda.wgmma_launches == wg + 1, f"{tag}: not on gemm_wgmma")
        # with a LayerNorm: the kernel's normalized A, exactly (an identity
        # weight), within one bf16 step of F.layer_norm's; the product is held on it
        a_ref, kw_ref = a, kw
        if "ln" in kw:
            eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
            a_ref = FL.fused_gemm_cuda(a, [eye], [torch.zeros(k, device=dev)], "bias",
                                       ln=kw["ln"], eps=kw["eps"])[0]
            ref = FL._layernorm(a, *kw["ln"], kw["eps"]).float()
            require(bool(((a_ref.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all()),
                    f"{tag}: the normalized A is not within a bf16 step of F.layer_norm's")
            kw_ref = {kk: vv for kk, vv in kw.items() if kk not in ("ln", "eps")}
            del eye, ref
        want = FL.gemm_reference(a_ref, ws, bs, epi, **kw_ref)
        product = None
        if epi != "bias":   # the product before gelu / the residual, held apart
            bare = {kk: vv for kk, vv in kw.items() if kk != "resid"}
            product = FL.gemm_reference(a_ref, ws, bs, "bias")
            ok, excess = gemm_bound_close(torch, FL.fused_gemm_cuda(a, ws, bs, "bias", **bare),
                                          product)
            require(ok, f"{tag}: the product is {excess} past 2^-7|want| + 2e-3")
        ok, excess = gemm_bound_close(torch, got, want, product, epi)
        require(bool(torch.isfinite(got.float()).all()) and ok,
                f"{tag}: {excess} past its per-element bound")
        require(torch.equal(got, FL.fused_gemm_cuda(a, ws, bs, epi, **kw)),
                f"{tag}: two calls differ")
        ga, gws, gbs, gkw, gxn = grid_gemm_case(torch, g, m, k, nseg, segs, "ln" in kw, epi)
        gk = FL.fused_gemm_cuda(ga, gws, gbs, epi, **gkw)
        if gxn is None:
            gr = FL.gemm_reference(ga, gws, gbs, epi, **gkw)
        else:   # the kernel's normalized rows exactly sign · g + b, and the rest on them
            eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
            require(torch.equal(FL.fused_gemm_cuda(ga, [eye], [torch.zeros(k, device=dev)],
                                                   "bias", **gkw)[0], gxn),
                    f"{tag}: the normalized grid rows are not exact")
            gr = FL.gemm_reference(gxn, gws, gbs, epi, **{kk: vv for kk, vv in gkw.items()
                                                          if kk not in ("ln", "eps")})
            del eye
        if not torch.equal(gk, gr):
            where = (gk != gr).nonzero()[:4].tolist()
            fail(f"{tag}: not bit-exact on grid inputs: {int((gk != gr).sum())} of {gk.numel()} "
                 f"differ, e.g. at {where}: kernel {[float(gk[tuple(i)]) for i in where]}, "
                 f"plain {[float(gr[tuple(i)]) for i in where]}")
        del ga, gws, gbs, gkw, gxn, gk, gr
        err = float((got.float() - want.float()).abs().max())
        e_ms, p_ms = timed_pair(torch, lambda: FL.fused_gemm_cuda(a, ws, bs, epi, **kw),
                                lambda: FL.gemm_reference(a, ws, bs, epi, **kw), iters=10)
        k_ms = graph_ms(lambda: FL.fused_gemm_cuda(a, ws, bs, epi, **kw), iters=20)
        # cuBLAS's bare product on the already-normalized input: less work (no
        # LN, no epilogue), so not the same function; timed only
        an = FL._layernorm(a, *kw["ln"], 1e-6) if "ln" in kw else a
        wcat = torch.cat(ws)
        cublas_ms = graph_ms(lambda: F.linear(an, wcat), iters=20)
        n = nseg * segs
        flops = 2.0 * m * n * k
        nbytes = 2 * (a.numel() + n * k + m * n) + 4 * n + (2 * m * n if "resid" in kw else 0)
        r = results[f"gemm.{role}"] = dict(
            row(err, k_ms, p_ms, nbytes, flops), cublas_bare_ms=cublas_ms)
        plan = FL.gemm_plan(m, nseg, segs, FL._sms(dev))
        step = "" if product is None else f" (+ a bf16 step of the product through {epi})"
        print(f"[kernels] {tag} [{m},{k}] x {segs} x [{nseg},{k}]^T"
              f"{' LN' if 'ln' in kw else ''} + {epi}: bn {plan.bn}, {plan.tiles} tiles on "
              f"{plan.grid} blocks; max|err| {err:.3g}"
              f"{' (on its own normalized A, itself within a bf16 step)' if 'ln' in kw else ''}, "
              f"within 2^-7|want| + 2e-3{step}, bit-exact on grid inputs, repeat "
              f"bit-identical | kernel {k_ms:.4f} ms (CUDA graph; eager call {e_ms:.4f}), "
              f"{flops / k_ms * 1e-9:.1f} TFLOP/s, plain {p_ms:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuBLAS bare product {cublas_ms:.4f} ms",
              flush=True)
        del got, want, product, an, wcat, a_ref

    # the LayerNorm statistics pre-pass alone
    got = FL.ln_stats_cuda(x2d, 1e-6)
    want = FL.ln_stats_reference(x2d, 1e-6)
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            f"ln_stats: max|err| {err} beyond rtol 1e-5 + atol 1e-6")
    require(torch.equal(got, FL.ln_stats_cuda(x2d, 1e-6)), "ln_stats: two calls differ")
    e_ms, p_ms = timed_pair(torch, lambda: FL.ln_stats_cuda(x2d, 1e-6),
                            lambda: FL.ln_stats_reference(x2d, 1e-6), iters=20)
    k_ms = graph_ms(lambda: FL.ln_stats_cuda(x2d, 1e-6), iters=20)
    results["ln_stats"] = row(err, k_ms, p_ms, x2d.numel() * 2 + m * 8, 4.0 * x2d.numel(),
                              F32_FLOPS)
    print(f"[kernels] ln_stats [{m},{h}] bf16: max|err| {err:.3g} (rtol 1e-5 + atol 1e-6), "
          f"repeat bit-identical | kernel {k_ms:.4f} ms (CUDA graph; eager call {e_ms:.4f}), "
          f"plain {p_ms:.3f} ms, bound {results['ln_stats']['bound_ms']:.4f} ms", flush=True)
    del x, x2d, hid
    torch.cuda.empty_cache()
    return results


def paged_kernels(torch, g, seed: int):
    """K7a and K7b at gemma-3-27b's heads, windows 0 and 1,024: phase 2's case
    (8 slots of up to 4,096 tokens), the paged batcher's decode step (4
    slots of 2,048 at 309-1,509 tokens, as in the generation breakdown) and
    run (e)'s decode step (16 slots of 1,024: ``split_plan`` gives one
    block a slot and head there, so no partials and no combine)."""
    from multimodal_colpali_tpu_torch._timing import cycle, graph_ms
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    dev = torch.device("cuda")
    c = K7
    hq, hkv, d, page = c["hq"], c["hkv"], c["d"], c["page"]
    scale = 168.0 ** -0.5                    # gemma-3-27b's query_pre_attn_scalar
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(b, nb, lengths, sets):
        n_pages = b * nb + 1
        q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
        pools = [(torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16),
                  torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16))
                 for _ in range(sets)]
        bt = torch.randperm(n_pages, generator=g, device=dev)[: b * nb].reshape(b, nb)
        if lengths is None:
            lens = torch.randint(1, nb * page + 1, (b,), generator=g, device=dev,
                                 dtype=torch.int32)
            lens[0], lens[1] = 0, nb * page          # an inactive slot, a full one
        else:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return q, pools, bt.to(torch.int32), lens

    # The outputs are softmax-weighted means of N(0, 1) rows, typically a few
    # hundredths, so a fixed atol alone could pass a kernel that drops a whole
    # split of a long slot. Each element is held to RTOL of its own size (the
    # bf16 rounding of the output: 1 ulp is 2^-8..2^-7 of it) plus ATOL (the
    # bf16 rounding of the probabilities, and for K7b's dequantize-first plain
    # version of the K and V rows too, so twice K7a's); a dropped 256-token
    # split moves the 4096-token slot by ~6e-3 rms. The issue's absolute limits
    # stay as floors. Then the same data in float32 (q and pools; K7b's codes
    # unchanged), where only the sum order differs: 1e-4 for K7a, 1e-3 for K7b.
    # bf16 takes the tensor-core path, float32 the CUDA-core path. The kernel
    # is timed as a CUDA-graph replay (a decode-shape call is shorter than its
    # eager launch); the decode step's case cycles over 4 sets of pools, as a
    # step reads each layer's own, so its 25-30 MB of rows are not served from
    # the 50 MB L2 cache.
    rtol = 2.0 ** -7
    shapes = (("phase 2", c["b"], c["nb"], None, 1),
              ("decode step", 4, 128, [309, 709, 1109, 1509], 4),
              ("run (e)", SWEEP["slots"], SWEEP["max_seq_len"] // page, sweep_lengths(seed), 1))
    results, errs = {}, {"paged_attention": [], "paged_attention_int8": []}
    for label, b, nb, lengths, sets in shapes:
        q, pools, bt, lens = case(b, nb, lengths, sets)
        int8 = [(*PA.quantize_kv_rows(kp), *PA.quantize_kv_rows(vp)) for kp, vp in pools]
        q32, kp32, vp32 = q.float(), pools[0][0].float(), pools[0][1].float()
        splits = PA.split_plan(b, hkv, nb * page, sms)

        def kv_bytes(window, per_row):
            """Bytes of the K and V rows this data needs (a slot of length 0
            reads every gathered V row for its uniform mean)."""
            total = 0
            for n in lens.tolist():
                rows = min(n, window) if window and n else n
                total += (2 * rows if n else nb * page) * hkv * per_row
            return total

        def k7a(q_, kp_, vp_, kernel=True):
            fn = PA.paged_attention_cuda if kernel else PA.paged_attention_reference
            return lambda w: fn(q_, kp_, vp_, bt, lens, scale=scale, window=w)

        def k7b(q_, pools_, kernel=True):
            fn = PA.paged_attention_int8_cuda if kernel else PA.paged_attention_int8_reference
            return lambda w: fn(q_, *pools_, bt, lens, scale=scale, window=w)

        for name, tag, floor, atol, f32_atol, per_row, kern, make in (
                ("paged_attention", "K7a", 2e-2, 2e-3, 1e-4, d * 2, PA.paged_attention_cuda,
                 lambda q_, i, kernel=True, f32=False: k7a(
                     q_, kp32 if f32 else pools[i][0], vp32 if f32 else pools[i][1], kernel)),
                ("paged_attention_int8", "K7b", 0.035, 4e-3, 1e-3, d + 4,
                 PA.paged_attention_int8_cuda,
                 lambda q_, i, kernel=True, f32=False: k7b(q_, int8[i], kernel))):
            call, plain = make(q, 0), make(q, 0, False)
            call32, plain32 = make(q32, 0, f32=True), make(q32, 0, False, f32=True)
            for window in (0, 1024):
                tc, cc = kern.tensor_core_launches, kern.cuda_core_launches
                got, want = call(window).float(), plain(window).float()
                torch.cuda.synchronize()
                require(kern.tensor_core_launches == tc + 1,
                        f"{tag} {label}: bf16 did not take the tensor-core path")
                require(bool(torch.isfinite(got).all()), f"{tag} {label}: non-finite output")
                diff = (got - want).abs()
                err, top = float(diff.max()), float(want.abs().max())
                excess = float((diff - rtol * want.abs()).max())
                require(err <= floor and excess <= atol,
                        f"{tag} {label} window {window}: max|err| {err} (floor {floor}), "
                        f"max(|err| - {rtol:.4g}|want|) {excess} > {atol}; max|want| {top}")
                got32, want32 = call32(window), plain32(window)
                require(kern.cuda_core_launches == cc + 1,
                        f"{tag} {label}: float32 did not take the CUDA-core path")
                err32 = float((got32 - want32).abs().max())
                require(got32.dtype == torch.float32 and err32 <= f32_atol,
                        f"{tag} {label} float32 window {window}: max|err| {err32} > {f32_atol}")
                require(torch.equal(call(window), call(window)),
                        f"{tag} {label} window {window}: two calls differ")
                errs[name].append(err)
                e_ms, p_ms = timed_pair(torch, lambda: call(window), lambda: plain(window),
                                        iters=10)
                k_ms = graph_ms(cycle([lambda i=i: make(q, i)(window)
                                       for i in range(sets)]), iters=20)
                nbytes = kv_bytes(window, per_row) + 2 * q.numel() * 2 + bt.numel() * 4
                rows = sum(min(n, window) if window else n for n in lens.tolist())
                r = row(err, k_ms, p_ms, nbytes, 4.0 * hq * d * rows)
                print(f"[kernels] {tag} {name} {label}: q {list(q.shape)} pools "
                      f"{list(pools[0][0].shape)} window {window}, lengths {lens.tolist()}, "
                      f"{splits} splits: bf16 (tensor cores) max|err| {err:.3g} (floor {floor}) "
                      f"with max|want| {top:.3g}, max(|err| - {rtol:.4g}|want|) {excess:.3g} "
                      f"(limit {atol}); float32 (CUDA cores) max|err| {err32:.3g} (limit "
                      f"{f32_atol}); repeat bit-identical | kernel {k_ms:.4f} ms (CUDA graph; "
                      f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
                results.setdefault(name, r)              # phase 2 at window 0 is the row
                del got, want, got32, want32, diff
        del q, pools, int8, q32, kp32, vp32
        torch.cuda.empty_cache()
    for name in results:
        results[name] = dict(results[name], max_abs_err=max(errs[name]))
    return results


def generation_kernels(torch, g, seed: int):
    """K7a, K7b, K8a and K8b at gemma-3-27b's decode shapes."""
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    dev = torch.device("cuda")
    results = paged_kernels(torch, g, seed)

    h, inter, vocab = K8["h"], K8["inter"], K8["vocab"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    w_up, w_down = codes(h, inter), codes(inter, h)
    s_up = torch.rand(inter, generator=g, device=dev) * 1e-3
    s_down = torch.rand(h, generator=g, device=dev) * 1e-3
    table = codes(vocab + (-vocab) % 512, h)          # the padded embed codes
    s_tab = torch.rand(table.shape[0], generator=g, device=dev) * 1e-3
    # the yardstick x @ w[N, K]^T * scale[N]: K8b's table as it is, K8a's codes
    # as transposed copies made once
    int8pack = library_op(torch, "_weight_int8pack_mm")
    nk_copy = {id(w_up): w_up.t().contiguous(), id(w_down): w_down.t().contiguous(),
               id(table): table} if int8pack else {}
    # K8a: decode rows (the row), prefill rows at 512 tokens (the prefill row)
    # and at 1,504 (the generation breakdown's prompt) through both projections
    cases = [("int8_matmul_kn", "K8a", 8, w_up, s_up, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 512, w_up, s_up, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 1504, w_up, s_up, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 1504, w_down, s_down, False, torch.bfloat16),
             ("int8_matmul_kn", "K8a", 8, w_down, s_down, False, torch.bfloat16),
             ("int8_matmul_nk", "K8b", 8, table, s_tab, True, torch.float32)]
    for name, tag, m, w, sc, nk, out in cases:
        k = w.shape[1] if nk else w.shape[0]
        n = w.shape[0] if nk else w.shape[1]
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        kernel = IM.int8_matmul_nk_cuda if nk else IM.int8_matmul_kn_cuda
        call = lambda: kernel(x, w, sc, out_dtype=out)  # noqa: E731
        plain = lambda: IM.int8_matmul_reference(x, w, sc, transpose_codes=nk)  # noqa: E731
        tile = "decode" if m <= 16 else "prefill"
        before = None if nk else getattr(kernel, f"{tile}_launches")
        got, want = call().float(), plain().float()
        torch.cuda.synchronize()
        require(nk or getattr(kernel, f"{tile}_launches") == before + 1,
                f"{tag} [{m}, {k}] did not take its {tile} tile")
        err = float((got - want).abs().max())
        limit = 0.02 * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"{tag} [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
        require(torch.equal(call(), call()), f"{tag} [{m}, {k}]: two calls differ")
        e_ms, p_ms = timed_pair(torch, call, plain, iters=10)
        k_ms = graph_ms(call, iters=20)
        lib_ms = mm_ms = None
        if int8pack:
            w_nk, s_x = nk_copy[id(w)], sc.to(x.dtype)
            lib_ms = eager_ms(lambda: int8pack(x, w_nk, s_x), iters=10 if m <= 16 else 2)
        if not nk and m > 16:     # context: cuBLAS on the weight already dequantized
            w_bf16 = w.to(torch.bfloat16)
            mm_ms = graph_ms(lambda: torch.mm(x, w_bf16), iters=10)
            del w_bf16
        r = row(err, k_ms, p_ms, w.numel() + sc.numel() * 4 + x.numel() * 2
                + m * n * (4 if out == torch.float32 else 2), 2.0 * m * k * n, library_ms=lib_ms)
        lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none on this torch"
        mm = f", bf16 torch.mm on the dequantized weight {mm_ms:.4f} ms" if mm_ms else ""
        print(f"[kernels] {tag} {name} x [{m}, {k}] bf16 x codes {list(w.shape)} int8 -> "
              f"{str(out).split('.')[-1]}{'' if nk else f' ({tile} tile)'}: max|err| {err:.3g} "
              f"(limit 2% of max, {limit:.3g}), repeat bit-identical, "
              f"{IM.split_count(m, n, k, sms, nk=nk)} K splits | kernel {k_ms:.4f} ms (CUDA graph; "
              f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, _weight_int8pack_mm {lib}{mm}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
        # the first decode shape is the row, the first prefill shape the prefill row
        results.setdefault(name if m <= 16 else f"{name}.prefill", r)
        del x, got, want
    # integer codes and x on a 2^-4 grid, a power-of-two scale: every product
    # and partial sum is exact in float32, so K8a must equal the float32 plain
    # product bit for bit on both tiles
    for m in (8, 200):
        c = codes(h, 1024)
        x = (torch.randint(-8, 8, (m, h), generator=g, device=dev) * 0.0625).to(torch.bfloat16)
        sc = torch.full((1024,), 2.0 ** -7, device=dev)
        got = IM.int8_matmul_kn_cuda(x, c, sc, out_dtype=torch.float32)
        require(torch.equal(got, IM.int8_matmul_reference(x.float(), c, sc)),
                f"K8a [{m}, {h}] differs from the plain version on grid inputs")
    print(f"[kernels] K8a on grid inputs [8 | 200, {h}] x [{h}, 1024]: both tiles equal the plain "
          f"version bit for bit", flush=True)
    del w_up, w_down, table, nk_copy, c, x, got
    torch.cuda.empty_cache()
    results.update(int4_kernels(torch, g, sms))
    return results


def paligemma_kernels(torch, g, results) -> None:
    """K7a, K8a (both tiles) and K8b at the shapes phase 7 gives them:
    PaliGemma's Gemma-2B LM (8 query heads over 1 KV head of 256; hidden
    2,048, MLP 16,384, vocab 257,216) in the paged batcher's 4 slots of
    6,144 tokens, pages of 16, at the lengths of a 1-page and a 5-page image
    prompt and of two text prompts. Each is held against its plain version
    at phase 2's limits; K7a's error joins its row's max_abs_err."""
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    dev = torch.device("cuda")
    cfg = RETRIEVER_CONFIGS[COLPALI]()
    t = cfg.text
    h, inter, hq, hkv, d = (t.hidden_size, t.intermediate_size, t.num_attention_heads,
                            t.num_key_value_heads, t.head_dim)
    b, page = IMG["slots"], IMG["page"]
    nb = IMG["max_seq_len"] // page
    patches = cfg.vision.num_patches
    lengths = [patches + 40, TOP_K * patches + 40, 330, 730]
    n_pages = b * nb + 1
    q = torch.randn(b, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    bt = torch.randperm(n_pages, generator=g, device=dev)[: b * nb].reshape(b, nb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kern = PA.paged_attention_cuda
    tc = kern.tensor_core_launches
    got = kern(q, kp, vp, bt, lens, scale=d ** -0.5).float()
    want = PA.paged_attention_reference(q, kp, vp, bt, lens, scale=d ** -0.5).float()
    torch.cuda.synchronize()
    require(kern.tensor_core_launches == tc + 1, "K7a PaliGemma: bf16 did not take the "
                                                 "tensor-core path")
    diff = (got - want).abs()
    err, excess = float(diff.max()), float((diff - 2.0 ** -7 * want.abs()).max())
    require(bool(torch.isfinite(got).all()) and err <= 2e-2 and excess <= 2e-3,
            f"K7a PaliGemma q {list(q.shape)} lengths {lengths}: max|err| {err} (floor 2e-2), "
            f"max(|err| - 2^-7|want|) {excess} > 2e-3")
    results["paged_attention"]["max_abs_err"] = max(results["paged_attention"]["max_abs_err"],
                                                    err)
    print(f"[kernels] K7a paged_attention at phase 7's shapes: q {list(q.shape)} pools "
          f"{list(kp.shape)}, lengths {lengths}: bf16 (tensor cores) max|err| {err:.3g} (floor "
          f"2e-2), max(|err| - 2^-7|want|) {excess:.3g} (limit 2e-3)", flush=True)
    del q, kp, vp, bt, got, want, diff

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    # decode rows: every projection of the layer (q/o, k/v, gate/up, down); prefill
    # rows of the 1-page and 5-page prompts through the MLP
    kn = [(b, h, h), (b, h, hkv * d), (b, h, inter), (b, inter, h),
          (lengths[0], h, inter), (lengths[0], inter, h),
          (lengths[1], h, inter), (lengths[1], inter, h)]
    cases = [(m, codes(k, n), False, torch.bfloat16) for m, k, n in kn]
    cases.append((b, codes(t.vocab_size + (-t.vocab_size) % 512, h), True, torch.float32))
    notes = []
    for m, w, nk, out in cases:
        k = w.shape[1] if nk else w.shape[0]
        sc = torch.rand(w.shape[0] if nk else w.shape[1], generator=g, device=dev) * 1e-3
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        kernel = IM.int8_matmul_nk_cuda if nk else IM.int8_matmul_kn_cuda
        tile = "decode" if m <= IM.DECODE_ROWS else "prefill"
        before = kernel.launches if nk else getattr(kernel, f"{tile}_launches")
        got = kernel(x, w, sc, out_dtype=out).float()
        want = IM.int8_matmul_reference(x, w, sc, transpose_codes=nk).float()
        torch.cuda.synchronize()
        tag = "K8b" if nk else f"K8a ({tile} tile)"
        require((kernel.launches if nk else getattr(kernel, f"{tile}_launches")) == before + 1,
                f"{tag} [{m}, {k}] x {list(w.shape)} did not launch")
        err = float((got - want).abs().max())
        limit = 0.02 * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"{tag} [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
        notes.append(f"{tag} [{m}, {k}] x {list(w.shape)} {err:.3g} (limit {limit:.3g})")
        del x, got, want, w, sc
    print(f"[kernels] K8a/K8b at phase 7's int8 shapes, max|err| against the plain version: "
          f"{'; '.join(notes)}", flush=True)
    torch.cuda.empty_cache()


def gemma3_prefill_kernels(torch, g) -> None:
    """K8a's prefill tile at the rows phase 8 gives it under int8 weights:
    gemma-3-27b's attention projections (q, k/v, o) and MLP (gate/up, down)
    at the bucketed rows of its 1-image and 5-image prompts and of the second
    question's tail after the pages it shares with the first, each held
    against its plain version at phase 2's limit (2% of the output's max)."""
    from types import SimpleNamespace
    from multimodal_colpali_tpu_torch.generation import Gemma3MMEngine, ModuloTokenizer
    from multimodal_colpali_tpu_torch.models.registry import GEMMA3_MM_CONFIGS
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    dev = torch.device("cuda")
    cfg = GEMMA3_MM_CONFIGS[GEN_MODEL]()
    t, page = cfg.text, G3_IMG["page"]
    tok = ModuloTokenizer(t.vocab_size)
    prompts = [Gemma3MMEngine.build_mm_prompt(SimpleNamespace(cfg=cfg), tok.encode(q),
                                              bos_id=tok.bos_id, newline_ids=tok.encode("\n"),
                                              n_images=n, **G3_IMG["marks"])
               for _, n, q in G3_ASKS]
    first, second = prompts[1], prompts[2]        # the two questions over the 5 images
    common = next(i for i, (a, b) in enumerate(zip(first, second)) if a != b)
    tail = len(second) - min(common // page, (len(second) - 1) // page) * page
    rows = sorted({-(-n // 16) * 16 for n in [len(p) for p in prompts] + [tail]})
    h, inter, qd, kvd = (t.hidden_size, t.intermediate_size,
                         t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim)
    kernel = IM.int8_matmul_kn_cuda
    notes = []
    for k, n in ((h, qd), (h, kvd), (qd, h), (h, inter), (inter, h)):
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=g, device=dev) * 1e-3
        for m in rows:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            before = kernel.prefill_launches
            got = kernel(x, w, sc, out_dtype=torch.bfloat16).float()
            want = IM.int8_matmul_reference(x, w, sc).float()
            torch.cuda.synchronize()
            require(kernel.prefill_launches == before + 1,
                    f"K8a [{m}, {k}] x {list(w.shape)} did not take its prefill tile")
            err = float((got - want).abs().max())
            limit = 0.02 * float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and err <= limit,
                    f"K8a [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
            notes.append(f"[{m}, {k}] x {list(w.shape)} {err:.3g} (limit {limit:.3g})")
            del x, got, want
        del w, sc
    print(f"[kernels] K8a (prefill tile) at phase 8's int8 prefill rows {rows} (prompts of "
          f"{[len(p) for p in prompts]} tokens, a {tail}-token tail), max|err| against the plain "
          f"version: {'; '.join(notes)}", flush=True)
    torch.cuda.empty_cache()


def int4pack_operands(torch, packed, scale, group: int):
    """K9's weight in the layout of ``torch._weight_int4pack_mm``: the codes
    of ``quantize_int4``'s group-split bytes as [N, K] nibbles, two to a byte
    (even k in the high nibble), through ``_convert_weight_to_int4pack``, and
    [K/G, N, 2] bf16 scales with zero points 0 (its dequantization is
    (q - 8) * scale + zero, K9's)."""
    half, n = packed.shape[0], packed.shape[1]
    groups = scale.shape[0]
    lo, hi = (packed & 15).view(groups, -1, n), (packed >> 4).view(groups, -1, n)
    codes = torch.cat([lo, hi], dim=1).reshape(2 * half, n).t()     # [N, K]
    nk = (codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8).contiguous()
    wp = torch._convert_weight_to_int4pack(nk, 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
    return wp, sz


def int4_kernels(torch, g, sms: int):
    """K9 at gemma-3-27b's projections, group 256: decode rows of the up and
    down projections, prefill rows, and exact equality on grid weights."""
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops.quant import quantize_int4

    dev = torch.device("cuda")
    h, inter, group = K8["h"], K8["inter"], 256

    def weights(k, n):
        packed = torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                               dtype=torch.int32).to(torch.uint8)
        return packed, torch.rand(k // group, n, generator=g, device=dev) * 1e-2

    up, down = weights(h, inter), weights(inter, h)
    int4pack = library_op(torch, "_weight_int4pack_mm")
    results = {}
    # decode rows (the row), prefill rows at 512 tokens (the prefill row) and at 1,504
    for m, (packed, sc) in ((8, up), (8, down), (512, up), (1504, up), (1504, down)):
        k, n = 2 * packed.shape[0], packed.shape[1]
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        call = lambda: I4.int4_matmul_kn_cuda(x, packed, sc)  # noqa: E731
        plain = lambda: I4.int4_matmul_reference(x, packed, sc)  # noqa: E731
        tile = "decode_launches" if m <= 16 else "prefill_launches"
        before = getattr(I4.int4_matmul_kn_cuda, tile)
        got, want = call().float(), plain().float()
        torch.cuda.synchronize()
        require(getattr(I4.int4_matmul_kn_cuda, tile) == before + 1,
                f"K9 [{m}, {k}] did not take its {tile.split('_')[0]} tile")
        err = float((got - want).abs().max())
        limit = 0.02 * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"K9 [{m}, {k}] x packed {list(packed.shape)}: max|err| {err} > 2% of max {limit}")
        require(torch.equal(call(), call()), f"K9 [{m}, {k}]: two calls differ")
        e_ms, p_ms = timed_pair(torch, call, plain, iters=10)
        k_ms = graph_ms(call, iters=20)
        lib_ms = lib_note = mm_ms = None
        if int4pack:
            wp, sz = int4pack_operands(torch, packed, sc, group)   # the repack, once
            lib_ms = eager_ms(lambda: int4pack(x, wp, group, sz), iters=10)
            lib_note = float((int4pack(x, wp, group, sz).float() - want).abs().max())
            del wp, sz
        if m > 16:     # context: cuBLAS on the weight already dequantized
            from multimodal_colpali_tpu_torch.ops.quant import dequantize_int4

            w_bf16 = dequantize_int4({"q4": packed, "scale": sc}, torch.bfloat16)
            mm_ms = graph_ms(lambda: torch.mm(x, w_bf16), iters=10)
            del w_bf16
        r = row(err, k_ms, p_ms, packed.numel() + sc.numel() * 4 + x.numel() * 2 + m * n * 2,
                2.0 * m * k * n, library_ms=lib_ms)
        lib = (f"{lib_ms:.3f} ms (max|diff| {lib_note:.3g})" if lib_ms is not None
               else "none on this torch")
        mm = f", bf16 torch.mm on the dequantized weight {mm_ms:.4f} ms" if mm_ms else ""
        print(f"[kernels] K9 int4_matmul_kn x [{m}, {k}] bf16 x packed {list(packed.shape)} "
              f"uint8 + scales {list(sc.shape)} -> bf16 ({tile.split('_')[0]} tile): max|err| "
              f"{err:.3g} (limit 2% of max, {limit:.3g}), repeat bit-identical, "
              f"{I4.split_count(m, n, k, sms)} K splits | kernel {k_ms:.4f} ms (CUDA graph; "
              f"eager call {e_ms:.4f}), plain {p_ms:.3f} ms, _weight_int4pack_mm {lib}{mm}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        results.setdefault("int4_matmul_kn" if m <= 16 else "int4_matmul_kn.prefill", r)
        del x, got, want
    # codes x 2^-3 with every (group, column) saturated, x on a 2^-4 grid: all
    # products and partial sums are exact in float32, so both tiles must equal
    # the plain version bit for bit (a nibble-order fault cannot)
    codes = torch.randint(-7, 8, (h, 1024), generator=g, device=dev).float()
    codes[::group] = 7.0
    q = quantize_int4(codes * 0.125, group=group)
    for m in (8, 200, 1504):
        x = (torch.randint(-128, 128, (m, h), generator=g, device=dev) * 0.0625).to(torch.bfloat16)
        got = I4.int4_matmul_kn_cuda(x, q["q4"], q["scale"], out_dtype=torch.float32)
        require(torch.equal(got, I4.int4_matmul_reference(x.float(), q["q4"], q["scale"])),
                f"K9 [{m}, {h}] differs from the plain version on power-of-two grid weights")
    print(f"[kernels] K9 on grid weights [8 | 200 | 1504, {h}] x [{h}, 1024]: both tiles equal "
          f"the plain version bit for bit", flush=True)
    del up, down, codes, q, x, got
    torch.cuda.empty_cache()
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


COLPALI = "vidore/colpali-v1.3"
CKPT_SHARDS = 3
# SigLIP LayerNorms and Gemma's (1 + w) RMSNorms: identity = weight 1 (0 in
# the Gemma LM), bias 0
NORM = re.compile(r"(layer_?norm\d?|\.norm)\.(weight|bias)$")


def colpali_hf_tensors(cfg):
    """(name, shape) of every tensor of a ``ColPaliForRetrieval`` checkpoint
    as transformers saves it, in its order: the SigLIP tower (without the
    pooling head PaliGemma does not use), the projector, the Gemma LM (its
    head is tied to the embedding table, so not saved) and the retrieval head."""
    v, t = cfg.vision, cfg.text
    h, inter = v.hidden_size, v.intermediate_size
    vt = "vlm.model.vision_tower.vision_model."
    out = [(vt + "embeddings.patch_embedding.weight", (h, 3, v.patch_size, v.patch_size)),
           (vt + "embeddings.patch_embedding.bias", (h,)),
           (vt + "embeddings.position_embedding.weight", (v.num_patches, h))]
    for i in range(v.num_hidden_layers):
        p = f"{vt}encoder.layers.{i}."
        out += [(p + "layer_norm1.weight", (h,)), (p + "layer_norm1.bias", (h,))]
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out += [(p + f"self_attn.{proj}.weight", (h, h)), (p + f"self_attn.{proj}.bias", (h,))]
        out += [(p + "layer_norm2.weight", (h,)), (p + "layer_norm2.bias", (h,)),
                (p + "mlp.fc1.weight", (inter, h)), (p + "mlp.fc1.bias", (inter,)),
                (p + "mlp.fc2.weight", (h, inter)), (p + "mlp.fc2.bias", (h,))]
    out += [(vt + "post_layernorm.weight", (h,)), (vt + "post_layernorm.bias", (h,)),
            ("vlm.model.multi_modal_projector.linear.weight", (v.projection_dim, h)),
            ("vlm.model.multi_modal_projector.linear.bias", (v.projection_dim,))]
    lm = "vlm.model.language_model."
    d, hd, ffn = t.hidden_size, t.head_dim, t.intermediate_size
    q, kv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    out.append((lm + "embed_tokens.weight", (t.vocab_size, d)))
    for i in range(t.num_hidden_layers):
        p = f"{lm}layers.{i}."
        out += [(p + "self_attn.q_proj.weight", (q, d)), (p + "self_attn.k_proj.weight", (kv, d)),
                (p + "self_attn.v_proj.weight", (kv, d)), (p + "self_attn.o_proj.weight", (d, q)),
                (p + "mlp.gate_proj.weight", (ffn, d)), (p + "mlp.up_proj.weight", (ffn, d)),
                (p + "mlp.down_proj.weight", (d, ffn)), (p + "input_layernorm.weight", (d,)),
                (p + "post_attention_layernorm.weight", (d,))]
    return out + [(lm + "norm.weight", (d,)), ("embedding_proj_layer.weight", (cfg.embedding_dim, d)),
                  ("embedding_proj_layer.bias", (cfg.embedding_dim,))]


def colpali_norm(name: str):
    """The identity value of a ColPali norm tensor (1 for a LayerNorm weight,
    0 for its bias and for Gemma's RMSNorm weight, which scales by 1 + w),
    None for any other tensor."""
    m = NORM.search(name)
    if not m:
        return None
    return 1.0 if m.group(2) == "weight" and ".language_model." not in name else 0.0


def write_colpali_checkpoint(torch, cfg, path: str, seed: int, shards: int = CKPT_SHARDS,
                             device: str = "cuda") -> dict:
    """A bf16 checkpoint of ``cfg`` in the HF layout (``colpali_hf_tensors``)
    through :func:`write_checkpoint`, its norms at their identity."""
    return write_checkpoint(torch, colpali_hf_tensors(cfg), path, seed, shards, device,
                            norm=colpali_norm)


COLQWEN = "vidore/colqwen2.5-v0.2"
# Qwen2's RMSNorms and the qwen2 variant's LayerNorms: identity = weight 1, bias 0
QWEN_NORM = re.compile(r"(norm1|norm2|ln_q|input_layernorm|post_attention_layernorm|\.norm)"
                       r"\.(weight|bias)$")


def colqwen_hf_tensors(cfg):
    """(name, shape) of every tensor of a ``ColQwen2ForRetrieval``
    checkpoint as transformers saves it: the vision tower (a conv patch
    embed over [2, 14, 14] blocks, the blocks, the merger), the Qwen2 LM
    and the retrieval head."""
    v, t = cfg.vision, cfg.text
    e, m2e, is_25 = v.embed_dim, v.spatial_merge_size ** 2 * v.embed_dim, v.variant == "qwen2_5"
    vis = "vlm.model.visual."
    out = [(vis + "patch_embed.proj.weight",
            (e, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size))]

    def norm(prefix):
        return [(prefix + ".weight", (e,))] + ([] if is_25 else [(prefix + ".bias", (e,))])

    def lin(prefix, o, i):
        return [(prefix + ".weight", (o, i)), (prefix + ".bias", (o,))]

    for i in range(v.depth):
        p = f"{vis}blocks.{i}."
        out += norm(p + "norm1") + norm(p + "norm2")
        out += lin(p + "attn.qkv", 3 * e, e) + lin(p + "attn.proj", e, e)
        if is_25:
            out += (lin(p + "mlp.gate_proj", v.mlp_hidden, e) + lin(p + "mlp.up_proj", v.mlp_hidden, e)
                    + lin(p + "mlp.down_proj", e, v.mlp_hidden))
        else:
            out += lin(p + "mlp.fc1", v.mlp_hidden, e) + lin(p + "mlp.fc2", e, v.mlp_hidden)
    out += norm(vis + "merger.ln_q") + lin(vis + "merger.mlp.0", m2e, m2e)
    out += lin(vis + "merger.mlp.2", v.hidden_size, m2e)
    lm = "vlm.model.language_model."
    d, hd, ffn = t.hidden_size, t.head_dim, t.intermediate_size
    q, kv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    out.append((lm + "embed_tokens.weight", (t.vocab_size, d)))
    for i in range(t.num_hidden_layers):
        p = f"{lm}layers.{i}."
        out += (lin(p + "self_attn.q_proj", q, d) + lin(p + "self_attn.k_proj", kv, d)
                + lin(p + "self_attn.v_proj", kv, d))
        out += [(p + "self_attn.o_proj.weight", (d, q)), (p + "mlp.gate_proj.weight", (ffn, d)),
                (p + "mlp.up_proj.weight", (ffn, d)), (p + "mlp.down_proj.weight", (d, ffn)),
                (p + "input_layernorm.weight", (d,)), (p + "post_attention_layernorm.weight", (d,))]
    return out + [(lm + "norm.weight", (d,))] + lin("embedding_proj_layer", cfg.embedding_dim, d)


def colqwen_norm(name: str):
    """The identity value of a ColQwen2 norm tensor (weight 1, bias 0), None
    for any other tensor."""
    m = QWEN_NORM.search(name)
    return None if not m else (1.0 if m.group(2) == "weight" else 0.0)


def write_checkpoint(torch, tensors, path: str, seed: int, shards: int, device: str,
                     norm) -> dict:
    """``tensors`` (name, shape) in bf16, written into ``path`` as ``shards``
    safetensors files by a minimal writer of the format (8-byte header
    length, JSON header padded to 8 bytes, raw bytes). A tensor for which
    ``norm(name)`` gives a value is filled with it; every other is
    N(0, fan_in^-0.5), fan_in the product of the dims after the first (a
    1-D tensor's own length), drawn on ``device`` from ``seed``. -> bytes,
    files, seconds."""
    import os

    sizes = [2 * math.prod(shape) for _, shape in tensors]
    total = sum(sizes)
    free = shutil.disk_usage(path).free
    require(free > total + 2**30, f"writing the {total / 1e9:.2f} GB checkpoint needs that much "
                                  f"and 1 GiB more free under {path}; {free / 1e9:.2f} GB are")
    groups = [[] for _ in range(shards)]
    done = 0
    for i, ((name, shape), size) in enumerate(zip(tensors, sizes)):
        groups[min(shards - 1, done * shards // total)].append((i, name, shape))
        done += size
    t0 = time.perf_counter()
    files = []
    for k, group in enumerate(groups):
        header, off = {}, 0
        for _, name, shape in group:
            n = 2 * math.prod(shape)
            header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [off, off + n]}
            off += n
        header["__metadata__"] = {"format": "pt"}
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        files.append(os.path.join(path, f"model-{k + 1:05d}-of-{shards:05d}.safetensors"))
        with open(files[-1], "wb") as f:
            f.write(len(raw).to_bytes(8, "little") + raw)
            for i, name, shape in group:
                ident = norm(name)
                if ident is not None:
                    t = torch.full(shape, ident, dtype=torch.bfloat16)
                else:
                    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
                    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
                    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
                    t = t.mul_(float(fan_in) ** -0.5).to(torch.bfloat16).cpu()
                f.write(t.view(torch.uint8).numpy())
    return dict(path=path, bytes=sum(os.path.getsize(f) for f in files), files=len(files),
                write_s=time.perf_counter() - t0)


def check_loaded_leaves(torch, model, cfg, path: str):
    """Eleven parameters across the tower, the projector, the LM and the head
    must equal the file's tensors after the converter's transposes. -> their
    names."""
    from multimodal_colpali_tpu_torch.models import hf_import
    from multimodal_colpali_tpu_torch.models.convert import params_from_flax

    state = params_from_flax(hf_import.colpali_params_from_hf(
        hf_import.load_state_dict(path), cfg), cfg)
    lv, lt = cfg.vision.num_hidden_layers - 1, cfg.text.num_hidden_layers - 1
    names = ["vision_tower.patch_embedding.weight", "vision_tower.position_embedding",
             "vision_tower.layers.0.self_attn.q_proj.weight",
             f"vision_tower.layers.{lv}.mlp.fc2.bias", "vision_tower.post_layernorm.weight",
             "multi_modal_projector.weight", "embed.embed_tokens",
             "language_model.layers.0.self_attn.k_proj.weight",
             f"language_model.layers.{lt}.mlp.down_proj.weight", "language_model.norm.weight",
             "embedding_proj_layer.weight"]
    params = dict(model.named_parameters())
    for name in names:
        got = params[name].detach().cpu()
        require(torch.equal(got, state[name].to(got.dtype)),
                f"{name} on the card differs from the checkpoint's tensor")
    return names


class PeakRss:
    """The growth of this process's resident memory over a ``with`` block:
    its RSS sampled every 2 ms by a thread (``/proc/self/statm``), the peak
    less the RSS at entry, in bytes."""

    @staticmethod
    def rss() -> int:
        import os

        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading

        self.base = self.peak = self.rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, self.rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())
        self.growth = self.peak - self.base


def kernel_wrappers():
    """Each kernel's wrapper, whose ``.launches`` counts its launches."""
    from multimodal_colpali_tpu_torch.ops import attention as A
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL
    from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA
    from multimodal_colpali_tpu_torch.ops import preprocess as PP
    from multimodal_colpali_tpu_torch.ops import window_attention as WA

    return {"maxsim": M.maxsim_scores_cuda, "attention": A.fused_attention_cuda,
            "attention_backward": A.fused_attention_backward_cuda,
            "normalize": PP.normalize_images_cuda, "maxsim_int8": M.maxsim_scores_int8_cuda,
            "vit_layer": FL.fused_vit_layer_cuda, "attn_block": FL.fused_vit_attention_block_cuda,
            "mlp_block": FL.fused_mlp_block_cuda, "gemm": FL.fused_gemm_cuda,
            "ln_stats": FL.ln_stats_cuda, "paged_attention": PA.paged_attention_cuda,
            "paged_attention_int8": PA.paged_attention_int8_cuda,
            "int8_matmul_kn": IM.int8_matmul_kn_cuda, "int8_matmul_nk": IM.int8_matmul_nk_cuda,
            "window_attention": WA.window_attention_cuda, "int4_matmul_kn": I4.int4_matmul_kn_cuda}


# the per-path counters of a wrapper beside its ``.launches``: K1's, K4's, K2's
# and K7's tensor-core and CUDA-core paths (K2's float32 path: 3xTF32), K8a's
# and K9's decode and prefill tiles, the K5 GEMM's wgmma and CUDA-core paths
# and its four roles, K6's ring, WMMA and CUDA-core kernels
PATHS = {"maxsim": ("tensor_core", "cuda_core"), "maxsim_int8": ("tensor_core", "cuda_core"),
         "gemm": ("wgmma", "cuda_core", "qkv", "out_proj", "fc1", "fc2"),
         "attention": ("tensor_core", "tf32", "cuda_core"),
         "int8_matmul_kn": ("decode", "prefill"),
         "int4_matmul_kn": ("decode", "prefill"),
         "paged_attention": ("tensor_core", "cuda_core"),
         "paged_attention_int8": ("tensor_core", "cuda_core"),
         "window_attention": ("ring", "wmma", "cuda_core")}


def reset_counts(wrappers) -> None:
    for name, fn in wrappers.items():
        fn.launches = 0
        for path in PATHS.get(name, ()):
            setattr(fn, f"{path}_launches", 0)


def read_counts(wrappers) -> dict:
    """Each wrapper's launches since ``reset_counts``, and its paths' as
    ``"<name>.<path>"``."""
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, paths in PATHS.items():
        for path in paths:
            counts[f"{name}.{path}"] = getattr(wrappers[name], f"{path}_launches")
    return counts


def page_files(pages, directory: str):
    """One file a page under ``directory``, its bytes unique to the page
    (a header naming it, then the first row of its pixels): the ``img_link``
    ``format_msgs`` base64-encodes. -> the paths, in page order."""
    out = []
    for i, page in enumerate(pages):
        path = Path(directory) / f"page{i:03d}.bin"
        path.write_bytes(f"page {i}\n".encode() + page[0].tobytes())
        out.append(str(path))
    return out


def phase_retrieval(torch, name: str, seed: int, card: str, tag: str, device_preprocess: bool,
                    path, absent, link_dir: str, checkpoint=None):
    """A retriever at full width through colpali_qdrant, retrieve_colpali,
    prompt_prep_query(type="colpali") and score_results (phases 3 and 6): the
    kernels in ``path`` must run, those in ``absent`` must not. Each page's
    ``img_link`` is a file under ``link_dir``. ``checkpoint``
    (``write_colpali_checkpoint``'s result) is loaded instead of a random
    init. -> (launches, the pages retrieved for the first query)."""
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.store import VectorClient

    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, PeakRss() as host:
        warnings.simplefilter("always")
        retr = load_retriever(name, device="cuda", dtype=torch.bfloat16, seed=seed,
                              device_preprocess=device_preprocess,
                              checkpoint_dir=checkpoint and checkpoint["path"])
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in retr.model.parameters())
    cfg = retr.model.cfg
    if checkpoint:
        require(not any("random init" in str(w.message) for w in caught),
                f"{name}: the checkpoint at {checkpoint['path']} was not loaded")
        leaves = check_loaded_leaves(torch, retr.model, cfg, checkpoint["path"])
        print(f"[{tag}] {name}: wrote a bf16 HF checkpoint of {checkpoint['bytes'] / 1e9:.2f} GB "
              f"in {checkpoint['files']} safetensors files in {checkpoint['write_s']:.1f} s; "
              f"load_retriever(checkpoint_dir=) {init_s:.2f} s = "
              f"{checkpoint['bytes'] / 1e9 / init_s:.2f} GB/s | host peak RSS growth "
              f"{host.growth / 1e9:.2f} GB | "
              f"device {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated | "
              f"{len(leaves)} leaves equal the file's | {card}", flush=True)
    size = getattr(cfg, "image_size", None) or cfg.vision.image_size
    pages = synthetic_pages(N_PAGES, size, seed)
    retr.embed_images(pages[:EMBED_BATCH], batch_size=EMBED_BATCH)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
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
    forwards = 2 * N_PAGES // EMBED_BATCH       # page batches embedded: the run above, indexing
    links = page_files(pages, link_dir)
    for u, user in enumerate(users):
        dataset = [{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                    "img_link": links[i]} for i in range(u * half, (u + 1) * half)]
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
    # prompt_prep_query's colpali mode: one image prompt a page retrieve_colpali finds
    want_links = [p.payload["img_link"] for p in api.retrieve_colpali(
        QUERIES[0], retr.processor, retr, client, "", "smoke", TOP_K).points]
    built = api.prompt_prep_query(QUERIES[0], "Q: {query}", client, "", "smoke", None, TOP_K,
                                  type="colpali", cp_model=retr, cp_processor=retr.processor)
    by_bytes = {Path(f).read_bytes(): f for f in links}
    got_links = [by_bytes[base64.b64decode(p[0]["content"][1]["image_url"]["url"].split(",")[1])]
                 for p in built["q_prompts"]]
    require(got_links == want_links and len(got_links) == TOP_K,
            f"prompt_prep_query(type='colpali') built prompts of {got_links}, "
            f"retrieve_colpali found {want_links}")
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
    launches = read_counts(wrappers)
    require(all(launches[k] > 0 for k in path), f"a kernel of the {name} path did not run: "
            f"{launches}")
    require(all(launches[k] == 0 for k in absent),
            f"{name} launched a kernel off its path ({', '.join(absent)}): {launches}")
    if "window_attention" in path:
        blocks = sum(cfg.vision.depths)       # spatial blocks: one launch each a forward
        require(launches["window_attention.ring"] == launches["window_attention"]
                == blocks * forwards,
                f"{name}: {launches['window_attention']} window-attention launches "
                f"({launches['window_attention.ring']} on the ring kernel), not {blocks} a "
                f"forward over {forwards} page batches, all on the ring kernel")
    pages_s = N_PAGES / embed_s
    print(f"[{tag}] {name} {n_params / 1e9:.3f}B params bf16 (init {init_s:.1f} s), "
          f"{N_PAGES} pages x {embs[0].shape[0]} tokens x {dim}: embed {pages_s:.2f} pages/s, "
          f"retrieve_colpali {np.mean(query_ms):.1f} ms/query (mean of "
          f"{', '.join(f'{t:.1f}' for t in query_ms)}), "
          f"filter ok, prompt_prep_query(colpali) built prompts of those pages, "
          f"top-{TOP_K} vs score_results "
          f"{'identical' if exact else 'equal up to ties'}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    del retr, client
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [index[p] for p in retrieved[0]]


def _key(p):
    return p.payload["document_name"], p.payload["page_no"]


def phase_colsmol(torch, seed: int, card: str):
    """Full-width ColSmol-256M through colpali_qdrant and query_points on the
    exact, int8, pooled and on_disk store modes."""
    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.store import (
        Distance, FieldCondition, Filter, MatchValue, MultiVectorConfig,
        QuantizationSearchParams, SearchParams, VectorClient, VectorParams)

    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    retr = load_retriever("vidore/colSmol-256M", device="cuda", dtype=torch.bfloat16,
                          seed=seed, device_preprocess=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in retr.model.parameters())
    size = retr.processor.image_preprocessor.image_size
    pages = synthetic_pages(SMOL_PAGES, size, seed + 1)
    retr.embed_images(pages[:SMOL_BATCH], batch_size=SMOL_BATCH)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    embs = retr.embed_images(pages, batch_size=SMOL_BATCH)
    embed_s = time.perf_counter() - t0
    dim = retr.model.cfg.embedding_dim
    require(len(embs) == SMOL_PAGES, "ColSmol embed_images: wrong number of pages")
    for e in embs:
        require(e.ndim == 2 and e.shape[1] == dim, f"ColSmol embedding shape {e.shape}")
        require(bool(np.isfinite(e).all()), "ColSmol: non-finite embedding")
        require(bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                "ColSmol: valid tokens are not unit-norm")

    # the partial fused kernels (K5b, K5c) through the same entry point
    parts_cos = {}
    for parts in ("attn", "mlp"):
        L.set_fused_parts(parts)
        try:
            other = retr.embed_images(pages[:SMOL_BATCH], batch_size=SMOL_BATCH)
        finally:
            L.set_fused_parts("both")
        for e in other:
            require(bool(np.isfinite(e).all()) and
                    bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                    f"ColSmol with fused parts {parts!r}: bad embedding")
        parts_cos[parts] = float(np.mean([np.sum(a * b, axis=-1).mean()
                                          for a, b in zip(other, embs)]))

    users = ["alice", "bob"]
    half = SMOL_PAGES // 2
    datasets = [[{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                  "img_link": ""} for i in range(u * half, (u + 1) * half)]
                for u in range(len(users))]

    def index(client, name):
        for user, dataset in zip(users, datasets):
            api.colpali_qdrant(dataset, [], [], retr, retr.processor, client, name,
                               batch_size=SMOL_BATCH, username=user)
        require(client.count(name).count == SMOL_PAGES, f"{name}: collection is incomplete")

    client = VectorClient(device="cuda")
    api.ensure_colpali_collection(client, "exact", vector_size=dim)
    api.ensure_colpali_collection(client, "int8", vector_size=dim, quantized=True)
    client.create_collection("pooled", VectorParams(size=dim, distance=Distance.COSINE,
                                                    multivector_config=MultiVectorConfig()),
                             quantized=True, prefilter="pooled")
    for name in ("exact", "int8", "pooled"):
        index(client, name)
    (REPO / "build").mkdir(exist_ok=True)
    disk_dir = Path(tempfile.mkdtemp(prefix="smoke-on-disk-", dir=REPO / "build"))
    try:
        disk = VectorClient(path=str(disk_dir), device="cuda")
        api.ensure_colpali_collection(disk, "on_disk", vector_size=dim, on_disk=True)
        index(disk, "on_disk")
        disk.save()
        disk = VectorClient(path=str(disk_dir), device="cuda")  # reopened: a memory map
        require(disk._get("on_disk").on_disk, "the reopened collection is not on_disk")
        colls = {"exact": client, "int8": client, "pooled": client, "on_disk": disk}
        vecs = {n: c._get(n)._vectors for n, c in colls.items()}
        require(all(np.array_equal(np.asarray(v), vecs["exact"]) for v in vecs.values()),
                "ColSmol: the four indexing runs embedded the pages differently")

        q_embs = retr.embed_queries(QUERIES)
        every = SearchParams(quantization=QuantizationSearchParams(
            ignore=False, oversampling=SMOL_PAGES / TOP_K))
        default = SearchParams(quantization=QuantizationSearchParams(ignore=False))
        alice = Filter(must=[FieldCondition(key="username", match=MatchValue(value="alice"))])
        full = {}   # exact scores of every page, per query
        recall = {n: [] for n in ("int8", "pooled", "on_disk")}
        mode_ms = {n: [] for n in colls}
        for qi, q in enumerate(q_embs):
            res = {}
            for name, c in colls.items():
                t0 = time.perf_counter()
                res[name] = c.query_points(name, q, limit=TOP_K, search_params=every).points
                mode_ms[name].append((time.perf_counter() - t0) * 1e3)
                flt = c.query_points(name, q, limit=TOP_K, query_filter=alice,
                                     search_params=every).points
                require(len(flt) == TOP_K and all(p.payload["username"] == "alice"
                                                  for p in flt),
                        f"{name}: the username filter returned another user's page")
            full[qi] = {_key(p): p.score for p in client.query_points(
                "exact", q, limit=SMOL_PAGES).points}
            ref = [(_key(p), p.score) for p in res["exact"]]
            require([(_key(p), p.score) for p in res["int8"]] == ref,
                     f"query {qi}: int8 with every page a candidate is not the exact scan "
                     f"bit for bit")
            require([(_key(p), p.score) for p in res["on_disk"]] ==
                    [(_key(p), p.score) for p in res["pooled"]],
                    f"query {qi}: on_disk differs from the device-resident pooled search")
            for a, b in zip(res["pooled"], res["exact"]):
                sa, sb = full[qi][_key(a)], full[qi][_key(b)]
                require(abs(sa - sb) <= 1e-2 * abs(sb) + 1e-2,
                        f"query {qi}: pooled top-{TOP_K} differs from exact beyond near-ties")
            want = {_key(p) for p in res["exact"]}
            for name in recall:
                got = client if name != "on_disk" else disk
                top = got.query_points(name, q, limit=TOP_K, search_params=default).points
                recall[name].append(len(want & {_key(p) for p in top}) / TOP_K)
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)

    api.retrieve_colpali("warm-up query", retr.processor, retr, client, "", "exact", TOP_K)
    query_ms = []
    for qtext in QUERIES:
        t0 = time.perf_counter()
        api.retrieve_colpali(qtext, retr.processor, retr, client, "", "exact", TOP_K)
        query_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    path = ("maxsim", "maxsim.tensor_core", "attention", "attention.tensor_core", "normalize",
            "maxsim_int8", "maxsim_int8.tensor_core", "vit_layer", "attn_block", "mlp_block",
            "gemm", "gemm.wgmma", "ln_stats")
    require(all(launches[k] > 0 for k in path),
            f"a kernel of the ColSmol path did not run: {launches}")
    # every bf16 GEMM of the tower on gemm_wgmma: 4 a K5a (12 a batch), 2 a
    # K5b or K5c, each role once a block it belongs to, none on the CUDA cores
    vit, att, mlpb = launches["vit_layer"], launches["attn_block"], launches["mlp_block"]
    layers = retr.model.cfg.vision.num_hidden_layers
    require(vit % layers == 0 and launches["gemm.wgmma"] == 4 * vit + 2 * att + 2 * mlpb
            and launches["gemm"] == launches["gemm.wgmma"] and launches["gemm.cuda_core"] == 0
            and launches["gemm.qkv"] == launches["gemm.out_proj"] == vit + att
            and launches["gemm.fc1"] == launches["gemm.fc2"] == vit + mlpb
            and launches["ln_stats"] == 2 * vit + att + mlpb,
            f"ColSmol's GEMMs did not all take gemm_wgmma as K5a-c chain them: {launches}")
    print(f"[colsmol] vidore/colSmol-256M {n_params / 1e6:.1f}M params bf16 (init {init_s:.1f} s), "
          f"{SMOL_PAGES} pages x {embs[0].shape[0]} tokens x {dim}: embed "
          f"{SMOL_PAGES / embed_s:.2f} pages/s (batches of {SMOL_BATCH}), retrieve_colpali "
          f"{np.mean(query_ms):.1f} ms/query (mean of {', '.join(f'{t:.1f}' for t in query_ms)}), "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}", flush=True)
    print(f"[colsmol] every page a candidate: int8 = exact bit for bit, on_disk = pooled bit "
          f"for bit, pooled = exact up to near-ties, filter ok | query_points ms (mean): "
          + ", ".join(f"{n} {np.mean(t):.2f}" for n, t in mode_ms.items())
          + f" | recall@{TOP_K} vs exact at oversampling 2.0: "
          + ", ".join(f"{n} {np.mean(r):.3f}" for n, r in recall.items())
          + f" | fused parts attn/mlp vs both: mean token cosine {parts_cos['attn']:.5f}/"
          f"{parts_cos['mlp']:.5f}", flush=True)
    print(f"[colsmol] launches {json.dumps(launches)}", flush=True)
    return launches


GEN_MODEL = "google/gemma-3-27b-it"
# phases 5 and 8 run the gemma-3-27b generator at full width and GEN_DEPTH of
# its 62 layers: with phase 15 added the script passed 17 minutes (1,142 s)
GEN_DEPTH = 16


@contextlib.contextmanager
def cut_depth(configs: dict, name: str, layers: int):
    """``configs[name]`` (a registry table) builds ``layers`` layers inside
    the block: a text config's, or a multimodal config's text tower's."""
    full = configs[name]

    def cut():
        cfg = full()
        if hasattr(cfg, "text"):
            return dataclasses.replace(cfg, text=dataclasses.replace(
                cfg.text, num_hidden_layers=layers))
        return dataclasses.replace(cfg, num_hidden_layers=layers)

    configs[name] = cut
    try:
        yield
    finally:
        configs[name] = full
GEN = dict(slots=4, max_seq_len=2048, chunk=8, page=16, max_tokens=32)
PROMPT_TOKENS = (320, 1100, 700, 1300, 1550)   # the chat prompt's tokens, roughly
INGEST = dict(papers=8, pages=(8, 12), lines=40, scanned=3, batch=8, figure=(240, 320),
              large_figure=(1400, 1800), jpeg_quality=90, table_lines=12, host_threads=8,
              ocr_threads=2, png_every=4)
INGEST_MODELS = [{"model_name": GEN_MODEL, "model_short": "gemma3", "port": 8006,
                  "text_vd": "RAG_TEXT", "mm_vd": "RAG_MM_gemma3", "late_inter": COLPALI,
                  "late_inter_short": "colpali"}]


def ingest_corpus(directory: Path, seed: int):
    """Phase 10's PDFs, written with the port's ``PdfWriter``: ``papers``
    letter-size papers of 8-12 pages (~40 text lines a page, a 240 x 320
    figure on every second page, every other one of them a baseline JPEG
    (DCTDecode, 4:2:0) and the rest zlib (FlateDecode), a ruled 4-row table
    on every fourth; paper 1's fourth page holds a 1400 x 1800 figure), and
    ``scan.pdf``: the first ``scanned`` pages of paper 1 rasterized at 144
    DPI and embedded as full-page images (no text layer). -> (the papers'
    paths, the scan's path, the titles of the scanned pages, [(paper path,
    page index, the JPEG figure's source pixels)])."""
    import numpy as np
    from multimodal_colpali_tpu_torch.ingest.pdfwrite import PdfWriter
    from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument, encode_jpeg

    rng = np.random.default_rng(seed)
    paths, jpegs = [], []
    for k in range(INGEST["papers"]):
        w = PdfWriter()
        path = directory / f"paper{k + 1:02d}.pdf"
        for page in range(int(rng.integers(INGEST["pages"][0], INGEST["pages"][1] + 1))):
            table = page % 4 == 3
            lines = [f"GLYCANS BIND SELECTINS PAPER {k + 1} PAGE {page + 1}"]
            for i in range(INGEST["lines"] - 1 - (INGEST["table_lines"] if table else 0)):
                words = " ".join(rng.choice(WORDS, size=int(rng.integers(5, 9))))
                lines.append(f"{i + 1}. {words} ({int(rng.integers(0, 10_000))}).")
            image = None
            if page % 2 == 1:
                fh, fw = INGEST["large_figure" if (k, page) == (0, 3) else "figure"]
                yy, xx = np.mgrid[0:fh, 0:fw]
                image = np.stack([(xx * 255 // fw), (yy * 255 // fh),
                                  np.full_like(xx, 40 * (k % 6))], -1).astype(np.uint8)
                for _ in range(6):
                    y, x = int(rng.integers(0, fh - 40)), int(rng.integers(0, fw - 60))
                    image[y: y + 40, x: x + 60] = rng.integers(0, 256, 3)
            if page % 4 == 1:
                jpegs.append((path, page, image))
                image = encode_jpeg(image, INGEST["jpeg_quality"])
            runs, rules = [], []
            if table:
                top = 200
                runs.append((72, top + 14, f"Table {page // 4 + 1}: binding constants, "
                                           f"paper {k + 1}"))
                rows = [["Glycan", "Lectin", "Kd (nM)"]] + [
                    [f"sLe{'xa'[r % 2]}-{r}", f"{'EPL'[r % 3]}-selectin",
                     str(int(rng.integers(10, 999)))] for r in range(3)]
                for r, row in enumerate(rows):
                    runs += [(x, top - 18 * r, cell) for x, cell in zip((72, 220, 380), row)]
                rules = [(68, top + 10, 470, top + 10), (68, top - 6, 470, top - 6),
                         (68, top - 62, 470, top - 62)]
            w.add_page(text_lines=lines, image=image, image_rect=(330, 420, 240, 180),
                       runs=runs, lines=rules)
        paths.append(path)
        w.save(str(path))
    source = PdfDocument(str(paths[0]))
    scan = PdfWriter()
    for page in range(INGEST["scanned"]):
        scan.add_page(image=source.render(page, dpi=144.0), image_rect=(0, 0, 612, 792))
    scan_path = directory / "scan.pdf"
    scan.save(str(scan_path))
    titles = [f"GLYCANS BIND SELECTINS PAPER 1 PAGE {page + 1}"
              for page in range(INGEST["scanned"])]
    return paths, scan_path, titles, jpegs


class Patched:
    """Replace ``owner.name`` by ``wrap(original)`` inside a ``with`` block:
    the script's own timers and recorders around the port's methods."""

    def __init__(self, owner, name: str, wrap):
        self.owner, self.name, self.wrap = owner, name, wrap

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.wrap(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def ocr_lines(lines) -> str:
    """``ConvOcr._page_words``' lines -> the text ``recognize`` returns."""
    return "\n".join(t for t in (" ".join(w for _, w in words)
                                 for _, _, words in lines if words) if t.strip())


def cpu_ocr_reference(scan_path: str, repo: str, threads: int):
    """Phase 10's CPU reading of the scan, run in a worker process beside the
    card's: ``AutoOcr(device="cpu").pdf_text_and_runs`` -> (its texts and
    runs, ConvOcr's page words, every classifier call's inputs and logits,
    seconds)."""
    sys.path.insert(0, repo)
    import torch

    from multimodal_colpali_tpu_torch.ingest import ocr_conv

    torch.set_num_threads(threads)
    lines, calls = [], []

    def page_words(orig):
        def run(self, image):
            out = orig(self, image)
            lines.append(out[0])
            return out
        return run

    def capture(orig):
        def run(self, patches, feats):
            out = orig(self, patches, feats)
            calls.append((patches, feats, out))
            return out
        return run

    t0 = time.perf_counter()
    with Patched(ocr_conv.ConvOcr, "_page_words", page_words), \
            Patched(ocr_conv.ConvOcr, "_forward", capture):
        out = ocr_conv.AutoOcr(device="cpu").pdf_text_and_runs(scan_path)
    return out, lines, calls, time.perf_counter() - t0


def phase_ingest(torch, seed: int, card: str, work: str, checkpoint: dict) -> dict:
    """Phase 10: PDF ingest at full width, on phase 3's ColPali checkpoint.
    -> the kernel launches of (a)-(c)."""
    import multiprocessing
    import os
    import warnings
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch._build import build_native
    from multimodal_colpali_tpu_torch.ingest import rasterize
    from multimodal_colpali_tpu_torch.drivers import create_context
    from multimodal_colpali_tpu_torch.ingest import imageops
    from multimodal_colpali_tpu_torch.ingest import ocr as template_ocr
    from multimodal_colpali_tpu_torch.ingest import ocr_conv
    from multimodal_colpali_tpu_torch.ingest.pipeline import PipelinedEmbedder
    from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image, resize_image_on
    from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.models.configs import BertConfig
    from multimodal_colpali_tpu_torch.store import VectorClient

    t_phase = time.perf_counter()
    lib = build_native()
    root = Path(work) / "ingest"
    papers_dir = root / "papers"
    papers_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    papers, scan_path, titles, jpegs = ingest_corpus(papers_dir, seed)
    pdfs = sorted(papers_dir.glob("*.pdf"))
    n_pages = sum(len(PdfDocument(str(p))) for p in pdfs)
    skipped_before = rasterize.skipped_jpeg_images()
    print(f"[ingest] mmpdf built by g++ with the port's JPEG decoder into {lib.name}; corpus: "
          f"{len(papers)} papers + a {INGEST['scanned']}-page scan, {n_pages} pages "
          f"({len(jpegs)} JPEG figures, one {INGEST['large_figure'][0]}x"
          f"{INGEST['large_figure'][1]} figure), written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    (root / "models.json").write_text(json.dumps(INGEST_MODELS))

    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)

    # (a) the create_context driver, with the OCR of the scan recorded and timed
    ocr = {"template_s": [], "conv_s": [], "device_ms": [], "lines": {}, "auto": None}

    def timed(key):
        def wrap(orig):
            def run(self, *a, **k):
                t = time.perf_counter()
                try:
                    return orig(self, *a, **k)
                finally:
                    ocr[key].append(time.perf_counter() - t)
            return run
        return wrap

    def device_timed(orig):
        def run(self, patches, feats):
            if self.device.type != "cuda":
                return orig(self, patches, feats)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(self, patches, feats)
            end.record()
            end.synchronize()
            ocr["device_ms"].append(start.elapsed_time(end))
            return out
        return run

    def page_words(orig):
        def run(self, image):
            t = time.perf_counter()
            out = orig(self, image)
            ocr["conv_s"].append(time.perf_counter() - t)
            ocr["lines"].setdefault(self.device.type, []).append(out[0])
            return out
        return run

    def auto_runs(orig):
        def run(self, path):
            out = orig(self, path)
            if self.conv is not None and self.conv.device.type == "cuda":
                ocr["auto"] = out
            return out
        return run

    # the driver finds phase 3's ColPali checkpoint and a bge-base one by the
    # models' names
    ckpt_root = Path(checkpoint["path"]).parent
    bge_dir = ckpt_root / BGE.replace("/", "--")
    bge_dir.mkdir()
    write_checkpoint(torch, bert_hf_tensors(BertConfig.bge_base()), str(bge_dir), seed, 1,
                     "cuda", norm=bert_norm)
    os.environ["COLPALI_TPU_CKPT_DIR"] = str(ckpt_root)
    os.environ["MMCP_DEVICE_PREPROCESS"] = "1"
    vd = root / "vd"
    # the CPU's reading of the scan runs in a worker process during (a)
    cpu_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_future = cpu_pool.submit(cpu_ocr_reference, str(scan_path), str(REPO),
                                     INGEST["ocr_threads"])
        with warnings.catch_warnings(record=True) as caught, \
                Patched(template_ocr.TemplateOcr, "recognize", timed("template_s")), \
                Patched(ocr_conv.ConvOcr, "_page_words", page_words), \
                Patched(ocr_conv.ConvOcr, "_forward", device_timed), \
                Patched(ocr_conv.AutoOcr, "pdf_text_and_runs", auto_runs):
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            stages = create_context.main([
                "--papers-dir", str(papers_dir), "--vd-dir", str(vd),
                "--models-config", str(root / "models.json"), "--prompts-path", "",
                "--skip-summaries", "--device", "cuda"])
            torch.cuda.synchronize()
            driver_s = time.perf_counter() - t0
        inits = [str(w.message) for w in caught if "random init" in str(w.message)]
        require(not inits, f"ingest (a) did not load the checkpoints: {inits}")
        t0 = time.perf_counter()
        cpu_auto, cpu_lines, calls, cpu_ocr_s = cpu_future.result()
        cpu_wait_s = time.perf_counter() - t0
        # (b) and (c) on one retriever: create_document_embeddings, then the
        # pipelined embedder over the same directory
        retr = load_retriever(COLPALI, device="cuda", dtype=torch.bfloat16,
                              checkpoint_dir=checkpoint["path"], device_preprocess=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = api.create_document_embeddings(str(papers_dir), retr, batch_size=INGEST["batch"])
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        spans = []

        def evented(orig):
            def run(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(*a, **k)
                end.record()
                spans.append((start, end))
                return out
            return run

        with Patched(retr, "_embed", evented):
            t0 = time.perf_counter()
            pipe = PipelinedEmbedder(retr, batch_size=INGEST["batch"]).embed_pdf_dir(
                str(papers_dir))
            torch.cuda.synchronize()
            pipe_s = time.perf_counter() - t0
    finally:
        os.environ.pop("MMCP_DEVICE_PREPROCESS", None)
        os.environ.pop("COLPALI_TPU_CKPT_DIR", None)
        cpu_pool.shutdown(cancel_futures=True)
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(launches["attention"] > 0 and launches["attention.tensor_core"] > 0,
            f"ingest: K2 did not run on its tensor-core path: {launches}")
    require(launches["normalize"] > 0, f"ingest: K3 did not run: {launches}")
    busy_ms = sum(a.elapsed_time(b) for a, b in spans)
    idle = 1.0 - busy_ms / (pipe_s * 1e3)

    # what came out: (b) = (c); the driver's files and collections
    require(len(seq) == len(pipe) == n_pages, f"embedded {len(seq)} / {len(pipe)} of "
            f"{n_pages} pages")
    worst = 0.0
    for a, b in zip(seq, pipe):
        require((a["doc_id"], a["page_id"], a["file_name"]) ==
                (b["doc_id"], b["page_id"], b["file_name"]),
                f"create_document_embeddings {a['file_name']} {a['page_id']} vs pipelined "
                f"{b['file_name']} {b['page_id']}")
        require(a["embedding"].shape == b["embedding"].shape
                and bool(np.isfinite(a["embedding"]).all()), "embedding shape or values")
        worst = max(worst, float(np.abs(a["embedding"] - b["embedding"]).max()))
    require(worst <= 2e-2, f"pipelined embeddings differ from create_document_embeddings' by "
            f"{worst:.3e} > 2e-2")
    pngs = sorted((vd / "pg_images").iterdir())
    require(len(pngs) == n_pages, f"{len(pngs)} page PNGs for {n_pages} pages")
    client = VectorClient(path=str(vd / "storage"), device="cuda")
    counts = {c.name: client.count(c.name).count for c in client.get_collections().collections}
    require(counts.get("colpali") == n_pages and counts.get("RAG_TEXT", 0) > 0
            and counts.get("RAG_MM_gemma3", 0) > counts.get("RAG_TEXT", 0),
            f"collections {counts}")
    points, _ = client.scroll("colpali", limit=n_pages + 1, with_vectors=True)
    by_page = {(r["file_name"], r["page_id"] + 1): r["embedding"] for r in seq}
    coll_worst = 0.0
    for pt in points:
        want = by_page[(pt.payload["document_name"], pt.payload["page_no"])]
        got = np.asarray(pt.vector, np.float32)
        require(got.shape == want.shape, f"collection vector {got.shape} vs {want.shape}")
        coll_worst = max(coll_worst, float(np.abs(got - want).max()))
    require(coll_worst <= 2e-2, f"the colpali collection's vectors differ from "
            f"create_document_embeddings' by {coll_worst:.3e}")
    n_tables = sum(1 for p in (vd / "tables").glob("*.png")) if (vd / "tables").exists() else 0

    # per page: the stages of the chain, and the card's resample against the host's
    pre = retr.processor.image_preprocessor
    tmp_png = root / "stage.png"
    kept, t_ms = [], {"rasterize": [], "upload+lanczos": [], "png_write": [], "bicubic": []}
    for path in pdfs:
        doc = PdfDocument(str(path))
        for i in range(len(doc)):
            t0 = time.perf_counter()
            raster = doc.render(i, dpi=144.0)
            t1 = time.perf_counter()
            lz = resize_image(torch.from_numpy(raster).to("cuda"))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if len(kept) % INGEST["png_every"] == 0:
                imageops.write_png(tmp_png, lz)
            t3 = time.perf_counter()
            u8 = pre.u8([lz], device="cuda")
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, dt in zip(t_ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                if key != "png_write" or len(kept) % INGEST["png_every"] == 0:
                    t_ms[key].append(dt * 1e3)
            kept.append((raster, lz.cpu().numpy(), u8[0].cpu().numpy()))

    def host_equal(item):
        raster, lz, u8 = item
        host_lz = resize_image(raster)
        host_u8 = imageops.resize(host_lz, (pre.image_size, pre.image_size), "bicubic")
        return bool(np.array_equal(host_lz, lz) and np.array_equal(host_u8, u8))

    # the host's int64 resample of every page, on threads (numpy releases the
    # interpreter lock)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(INGEST["host_threads"]) as pool:
        equal = list(pool.map(host_equal, kept))
    host_s = time.perf_counter() - t0
    require(all(equal), f"the card's float64 resample differs from the host int64 path on "
            f"{equal.count(False)} of {len(equal)} pages")
    require(not any(launches[k] for k in ("maxsim", "window_attention", "vit_layer")),
            f"ingest launched a kernel off its path: {launches}")

    # the figures pdf_loader saves: every one resized by resize_image on the
    # card as on the host (the large one LANCZOS to 1,300), and each JPEG
    # figure decoded by the port's decoder close to the pixels it was made from
    figures, fig_ms = [], []
    for path in pdfs:
        doc = PdfDocument(str(path))
        for i in range(len(doc)):
            for img, _ in doc.extract_images(i):
                t0 = time.perf_counter()
                card_fig = resize_image_on(img, torch.device("cuda")).cpu().numpy()
                fig_ms.append((time.perf_counter() - t0) * 1e3)
                figures.append((path, i, img, card_fig))
    fig_equal = [bool(np.array_equal(resize_image(img), got)) for _, _, img, got in figures]
    require(all(fig_equal), f"the card's resample of {fig_equal.count(False)} of "
            f"{len(figures)} figures differs from the host's")
    large = [got.shape for _, _, img, got in figures
             if img.shape[:2] == INGEST["large_figure"]]
    require(large == [(1011, 1300, 3)], f"the large figure's resized shapes: {large}")
    jpeg_err = 0.0
    for path, page, src in jpegs:
        got = [img for p, i, img, _ in figures if (p, i) == (path, page)]
        require(len(got) == 1 and got[0].shape == src.shape,
                f"{path.name} page {page + 1}: the JPEG figure was not extracted at "
                f"{src.shape}: {[g.shape for g in got]}")
        jpeg_err = max(jpeg_err, float(np.abs(got[0].astype(np.int16) - src).mean()))
    require(jpeg_err < 2.5, f"a JPEG figure decodes {jpeg_err:.2f} levels from its source "
            f"on average")
    skipped = rasterize.skipped_jpeg_images() - skipped_before
    require(skipped == 0, f"{skipped} JPEG images could not be decoded in phase 10")

    # the scan: the card's OCR against the CPU's
    require(ocr["auto"] is not None, "the scanned paper did not go through AutoOcr on the card")
    texts, _ = ocr["auto"]
    for title, text in zip(titles, texts):
        require("GLYCANS" in text and "SELECTINS" in text and title in text,
                f"the scan's OCR text lacks its source's words {title!r}: {text[:200]!r}")
    require(cpu_auto == ocr["auto"], "AutoOcr on the card read the scan otherwise than on the "
            "CPU")
    card_lines = ocr["lines"].get("cuda", [])
    require(len(card_lines) == len(cpu_lines) == INGEST["scanned"]
            and [ocr_lines(x) for x in card_lines] == [ocr_lines(x) for x in cpu_lines]
            and card_lines == cpu_lines, "ConvOcr's text or word positions on the card differ "
            "from the CPU's")
    conv_card = ocr_conv.ConvOcr(device="cuda")
    logit_err = max(float(np.abs(conv_card._forward(pa, fe) - out).max())
                    for pa, fe, out in calls)
    require(logit_err <= 1e-4, f"ConvOcr logits on the card differ from the CPU's by "
            f"{logit_err:.3e} > 1e-4")
    glyphs = sum(len(pa) for pa, _, _ in calls)
    ms = {k: float(np.mean(v)) for k, v in t_ms.items()}
    scan_pages = INGEST["scanned"]
    print(f"[ingest] (a) create_context --skip-summaries (bge-base and {COLPALI} from bf16 checkpoints, "
          f"MMCP_DEVICE_PREPROCESS=1): {driver_s:.1f} s for {n_pages} pages = "
          f"{n_pages / driver_s:.2f} pages/s; stages (s) "
          f"{json.dumps({k: round(v, 2) for k, v in stages.items()})}; collections {counts}, "
          f"{len(pngs)} page PNGs, {n_tables} table crops | {card}", flush=True)
    print(f"[ingest] (b) create_document_embeddings {seq_s:.2f} s = {n_pages / seq_s:.2f} "
          f"pages/s; (c) PipelinedEmbedder(batch_size={INGEST['batch']}) {pipe_s:.2f} s = "
          f"{n_pages / pipe_s:.2f} pages/s, forwards {busy_ms:.0f} ms of device time "
          f"({busy_ms / len(spans):.1f} ms a batch of {INGEST['batch']}), device idle "
          f"{100 * idle:.1f}% of (c)'s wall; (b) = (c) within {worst:.2e}, the colpali "
          f"collection = (b) within {coll_worst:.2e}; peak {peak:.2f} GiB | {card}",
          flush=True)
    print(f"[ingest] ms a page (means over {len(kept)} pages): rasterize "
          f"{ms['rasterize']:.1f} (host, 144 DPI), upload + LANCZOS {ms['upload+lanczos']:.2f} "
          f"(card, to {kept[0][1].shape[1]}x{kept[0][1].shape[0]}), PNG write "
          f"{ms['png_write']:.1f} (host zlib; every {INGEST['png_every']}th page), BICUBIC "
          f"{ms['bicubic']:.2f} (card, to {pre.image_size}); the card's float64 resample "
          f"bit-equal to the host's int64 on every page (host check {host_s:.1f} s on "
          f"{INGEST['host_threads']} threads) | "
          f"{card}", flush=True)
    print(f"[ingest] figures: {len(figures)} extracted ({len(jpegs)} JPEG, decoded by the "
          f"port's decoder within {jpeg_err:.2f} levels a pixel of their sources, none "
          f"skipped), resize_image on the card {float(np.mean(fig_ms)):.2f} ms a figure "
          f"(upload, resample, copy back; {max(fig_ms):.1f} ms the 1400x1800 one), bit-equal "
          f"to the host's | {card}", flush=True)
    print(f"[ingest] OCR of the {scan_pages}-page scan in (a): template "
          f"{1e3 * sum(ocr['template_s']) / scan_pages:.0f} ms a page, ConvOcr "
          f"{1e3 * sum(ocr['conv_s']) / scan_pages:.0f} ms a page (288 DPI) of which its "
          f"classifier on the card {sum(ocr['device_ms']) / scan_pages:.1f} ms "
          f"({len(ocr['device_ms'])} forwards); the same on the CPU {cpu_ocr_s:.1f} s in a "
          f"worker process beside (a) ({cpu_wait_s:.1f} s waited after it): text, "
          f"runs and ConvOcr's words identical, logits within {logit_err:.2e} over {glyphs} "
          f"glyphs; the source's titles read back | {card}", flush=True)
    print(f"[ingest] launches {json.dumps(launches)}; phase 10 took "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    del retr, client, conv_card, kept
    gc.collect()
    torch.cuda.empty_cache()
    return launches


MCQ_FORMAT = {"type": "json_schema", "json_schema": {"name": "mcq", "schema": {
    "type": "object", "properties": {"answer": {"type": "string",
                                                "enum": ["A", "B", "C", "D"]}}}}}
WORDS = ("selectin", "glycan", "ligand", "binding", "affinity", "sialyl", "Lewis", "fucose",
         "leukocyte", "endothelial", "adhesion", "rolling", "receptor", "domain", "lectin",
         "calcium", "epitope", "antibody", "assay", "kinetics", "dissociation", "constant",
         "measured", "surface", "plasmon", "resonance", "table", "figure", "supplementary",
         "protein", "mutant", "wild-type", "structure", "crystal", "residue", "pocket")


def mcq_prompt(rng, n_tokens: int) -> str:
    """A RAG-style multiple-choice prompt of about ``n_tokens`` byte tokens:
    retrieved context passages, a question and four options."""
    tail = ("\nQuestion: Which statement about selectin binding is supported by the "
            "context?\nOptions: A) calcium is required B) fucose is dispensable "
            "C) affinity is nanomolar D) rolling needs no shear\nAnswer with the letter.")
    parts, n, doc = [], 0, 0
    budget = n_tokens - len(tail) - 20
    while n < budget:
        doc += 1
        sent = " ".join(rng.choice(WORDS, size=int(rng.integers(12, 30))))
        piece = f"[Doc {doc}, page {int(rng.integers(1, 20))}] {sent.capitalize()}. "
        parts.append(piece)
        n += len(piece)
    return "Context:\n" + "".join(parts)[:budget] + tail


def chat(base_url: str, body: dict):
    """POST a chat completion; -> (status, reply text, finish_reason, seconds).
    A streamed reply is read event by event and its deltas joined."""
    import urllib.request

    req = urllib.request.Request(base_url + "/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        if not body.get("stream"):
            out = json.loads(resp.read())["choices"][0]
            return resp.status, out["message"]["content"], out["finish_reason"], \
                time.perf_counter() - t0
        text, finish = [], None
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            ev = json.loads(line[6:])
            require("error" not in ev, f"stream error event {ev}")
            text.append(ev["choices"][0]["delta"].get("content", ""))
            finish = ev["choices"][0]["finish_reason"] or finish
        return resp.status, "".join(text), finish, time.perf_counter() - t0


def first_divergence(engine, ids, got, want):
    """None when the streams agree; else (step, gap of the engine's top two
    logits there)."""
    import numpy as np

    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            break
    else:
        require(len(got) == len(want), f"stream lengths differ: {len(got)} vs {len(want)}")
        return None
    top2 = np.sort(engine.next_token_logits([ids + want[:i]])[0])[-2:]
    return i, float(top2[1] - top2[0])


def serve_run(torch, engine, tok, tag: str, kv_dtype: str, requests, card: str):
    """One run of phase 5: the paged batcher and the HTTP server over
    ``engine``; every request sent at once. Returns the launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_colpali_tpu_torch.generation import (
        GenerationServer, PagedContinuousBatcher, render_chat_prompt)

    wrappers = kernel_wrappers()
    bat = PagedContinuousBatcher(engine, batch_slots=GEN["slots"],
                                 max_seq_len=GEN["max_seq_len"], chunk=GEN["chunk"],
                                 page_size=GEN["page"], kv_dtype=kv_dtype,
                                 eos_id=tok.eos_id).serve()
    srv = GenerationServer(bat, tok, model_name=GEN_MODEL, host="127.0.0.1", port=0).start()
    try:
        status, _, _, _ = chat(srv.base_url, {"messages": [{"role": "user", "content": "warm"}],
                                              "max_tokens": 2})         # warm-up
        require(status == 200, f"[{tag}] warm-up request failed")
        torch.cuda.synchronize()
        bat.decode_s, bat.decode_steps, bat.decode_tokens, bat.ttft_s = 0.0, 0, 0, []
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as ex:
            outs = list(ex.map(lambda r: chat(srv.base_url, r[1]), requests))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
        bat.shutdown()
    stats = dict(decode_s=bat.decode_s, steps=bat.decode_steps, tokens=bat.decode_tokens,
                 ttft=list(bat.ttft_s), preemptions=bat.preemptions)
    del srv, bat   # the server holds the batcher (and its pools) until it goes
    gc.collect()
    torch.cuda.empty_cache()

    greedy_notes, sampled = [], []
    for (kind, body), (status, text, finish, secs) in zip(requests, outs):
        require(status == 200 and text, f"[{tag}] {kind} request failed: {status} {text!r}")
        if kind == "mcq":
            require(json.loads(text).get("answer") in ("A", "B", "C", "D"),
                    f"[{tag}] the MCQ reply is not a choice: {text!r}")
            continue
        got = [int(t) for t in text.split()]
        require(len(got) == GEN["max_tokens"] and finish == "length",
                f"[{tag}] {kind}: {len(got)} tokens, finish {finish}")
        if kind == "sampled":
            sampled.append(got)
            continue
        ids = tok.encode(render_chat_prompt(body["messages"]), add_special_tokens=True)
        want = engine.generate([ids], max_new_tokens=GEN["max_tokens"], eos_id=tok.eos_id)[0]
        div = first_divergence(engine, ids, got, want)
        if div is None:
            greedy_notes.append(f"{len(ids)} tok: identical")
        else:
            require(div[1] <= 0.05, f"[{tag}] a {len(ids)}-token greedy stream first differs "
                                    f"from the engine's at step {div[0]}, where the top two "
                                    f"logits are {div[1]:.4f} apart (> 0.05)")
            greedy_notes.append(f"{len(ids)} tok: first differs at step {div[0]} (top-2 gap "
                                f"{div[1]:.4f})")
    if sampled:
        require(len(sampled) == 2 and sampled[0] == sampled[1],
                f"[{tag}] the two sampled replies with one seed differ")
    tok_s = stats["tokens"] / stats["decode_s"] if stats["decode_s"] else 0.0
    step_ms = 1e3 * stats["decode_s"] / max(stats["steps"], 1)
    print(f"[gen-{tag}] {len(requests)} concurrent requests in {wall:.1f} s | decode "
          f"{tok_s:.1f} tokens/s over {GEN['slots']} slots, {step_ms:.1f} ms per decode step "
          f"(one output token of every active slot), "
          f"{1e3 / tok_s if tok_s else float('nan'):.1f} ms per output token | TTFT ms "
          f"{[round(1e3 * t) for t in stats['ttft']]} | peak {peak:.1f} GiB | preemptions "
          f"{stats['preemptions']} | greedy vs engine.generate: {'; '.join(greedy_notes)} | "
          f"{'sampled pair equal, MCQ reply a choice | ' if sampled else ''}{card}", flush=True)
    print(f"[gen-{tag}] launches {json.dumps(launches)}", flush=True)
    return launches


SWEEP = dict(questions=120, slots=16, max_seq_len=1024, chunk=8, page=16, max_tokens=8,
             resend=8, check=4, prompt_tokens=(860, 1000))
RESP_LABELS = ["A", "B", "C", "D"]


def exp02_prompt(question: str, answers) -> str:
    """Driver 05's generation prompt (drivers/05_experiment02.py:69-90)."""
    question_string = "".join(f"{label}. {option}" for label, option in zip(RESP_LABELS, answers))
    return (
        f"You are an experienced senior researcher tasked with providing in-depth analysis.\n"
        f"Use all the information at your disposal, such as uploaded files and other sources. "
        f"Think about the following statement or question: {question}\n"
        f"Below are the possible answers, where letters mark each answer. "
        f"First, exclude the unlikely answer or answers, rethink, and select an output from the "
        f"rest. The output is only ONE letter from the list {RESP_LABELS}. "
        f"Check that you return only one letter; if two letters, choose one. No explanations. "
        f"The answers are:\n{question_string}"
    )


def sweep_questions(seed: int, tok, n: int):
    """Run (e)'s first ``n`` synthetic benchmark questions in driver 05's
    wording, each chat prompt (BOS included) of ``SWEEP["prompt_tokens"]``
    tokens, so that it buckets below the 1,024-token slot with room for 8
    new tokens."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import render_chat_prompt

    rng = np.random.default_rng(seed + 14)
    lo, hi = SWEEP["prompt_tokens"]
    out = []
    for _ in range(n):
        target = int(rng.integers(lo, hi))
        answers = [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 7)))) for _ in range(4)]
        question, msgs = "Which statement about", None
        while True:
            nxt = question + " " + str(rng.choice(WORDS))
            cand = [{"role": "user", "content": exp02_prompt(nxt + "?", answers)}]
            if len(tok.encode(render_chat_prompt(cand), add_special_tokens=True)) > target:
                break
            question, msgs = nxt, cand
        out.append(msgs)
    return out


def sweep_lengths(seed: int):
    """K7's lengths at one of run (e)'s decode steps: its first 16 questions'
    prompts in the 16 slots, slot i ``i % 8`` tokens into its reply."""
    from multimodal_colpali_tpu_torch.generation import ModuloTokenizer, render_chat_prompt
    from multimodal_colpali_tpu_torch.models.registry import GEMMA3_CONFIGS

    tok = ModuloTokenizer(GEMMA3_CONFIGS[GEN_MODEL]().vocab_size)
    return [len(tok.encode(render_chat_prompt(m), add_special_tokens=True))
            + i % SWEEP["max_tokens"]
            for i, m in enumerate(sweep_questions(seed, tok, SWEEP["slots"]))]


def choice_gap(engine, srv, msgs) -> float:
    """The gap between the two best choices' logits at the constrained
    scaffold, scored as ``srv`` scores them (its ``_constrained_prompt``)."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import extract_chat_content, mcq_response_format

    field, choices = srv._schema_enum({"response_format": mcq_response_format()})
    _, ids, firsts = srv._constrained_prompt(extract_chat_content(msgs)[0], field, choices)
    top2 = np.sort(engine.next_token_logits([ids])[0][firsts])[-2:]
    return float(top2[1] - top2[0])


def mcq_sweep(torch, engine, tok, seed: int, card: str):
    """Run (e): the experiment's 120-question sweep through the port's client,
    structured (sweep 1, the server's constrained path) then free text (sweep
    2, the batcher). Returns the launch counts of both sweeps."""
    import resource
    import threading

    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        ERROR_SENTINEL, GenerationServer, PagedContinuousBatcher, get_responses, identity_perm,
        mcq_response_format, render_chat_prompt, resolve_endpoint, response_real_out,
        run_inference, run_sync)
    from multimodal_colpali_tpu_torch.utils import health, housekeeping

    t_run = time.perf_counter()
    wrappers = kernel_wrappers()
    msgs = sweep_questions(seed, tok, SWEEP["questions"])
    n_prompt = [len(tok.encode(render_chat_prompt(m), add_special_tokens=True)) for m in msgs]
    require(max(n_prompt) + SWEEP["max_tokens"] <= SWEEP["max_seq_len"] - 16,
            f"(e) a prompt of {max(n_prompt)} tokens leaves no room for the reply")
    bat = PagedContinuousBatcher(engine, batch_slots=SWEEP["slots"],
                                 max_seq_len=SWEEP["max_seq_len"], chunk=SWEEP["chunk"],
                                 page_size=SWEEP["page"], eos_id=tok.eos_id).serve()
    srv = GenerationServer(bat, tok, model_name=GEN_MODEL, host="127.0.0.1", port=0).start()
    health_url = srv.base_url.rsplit("/v1", 1)[0] + "/health"
    inflight, lock, complete = {"now": 0, "peak": 0}, threading.Lock(), srv._complete

    def counted(req):          # the requests inside the server at once
        with lock:
            inflight["now"] += 1
            inflight["peak"] = max(inflight["peak"], inflight["now"])
        try:
            return complete(req)
        finally:
            with lock:
                inflight["now"] -= 1
    srv._complete = counted
    url, headers = resolve_endpoint(GEN_MODEL, base_url=srv.base_url)
    res = {}
    try:
        require(health.check_vllm_status(health_url), f"(e) {health_url} is not healthy")
        for body in ({"messages": msgs[0], "max_tokens": 2},
                     {"messages": msgs[0], "response_format": mcq_response_format()}):
            require(chat(srv.base_url, body)[0] == 200, "(e) warm-up request failed")
        torch.cuda.synchronize()
        for sweep in ("structured", "free"):
            bat.decode_s, bat.decode_steps, bat.decode_tokens, bat.ttft_s = 0.0, 0, 0, []
            inflight["peak"] = 0
            torch.cuda.reset_peak_memory_stats()
            reset_counts(wrappers)
            t0 = time.perf_counter()
            if sweep == "structured":
                replies = run_sync(run_inference(GEN_MODEL, msgs, url, headers, use_schema=True))
            else:
                replies = run_sync(get_responses(GEN_MODEL, 0, msgs, base_url=srv.base_url,
                                                 extra_body={"max_tokens": SWEEP["max_tokens"]}))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            stats = housekeeping.device_memory_stats()
            free, total = torch.cuda.mem_get_info()
            res[sweep] = dict(replies=replies, wall=wall, launches=read_counts(wrappers),
                              peak=torch.cuda.max_memory_allocated(), stats=stats,
                              used=total - free, reserved=torch.cuda.memory_reserved(),
                              inflight=inflight["peak"], decode_s=bat.decode_s,
                              tokens=bat.decode_tokens, steps=bat.decode_steps,
                              ttft=list(bat.ttft_s))
        resent = [chat(srv.base_url, {"messages": msgs[i], "response_format":
                                      mcq_response_format()})
                  for i in range(SWEEP["resend"])]
    finally:
        srv.stop()
        bat.shutdown()
    require(not health.check_vllm_status(health_url), f"(e) {health_url} healthy after stop")
    gaps = {i: choice_gap(engine, srv, msgs[i]) for i, r in enumerate(resent)
            if r[1] != res["structured"]["replies"][i]}
    del srv, bat
    gc.collect()
    torch.cuda.empty_cache()

    s1, s2 = res["structured"], res["free"]
    for i, reply in enumerate(s1["replies"]):
        require(isinstance(reply, str) and reply != ERROR_SENTINEL,
                f"(e) structured reply {i} failed: {reply!r}")
        answer = json.loads(reply).get("answer")
        require(answer in RESP_LABELS and response_real_out(reply, identity_perm())
                == (answer, answer), f"(e) structured reply {i} is not a choice: {reply!r}")
    tie_notes = []
    for i, (status, text, _, _) in enumerate(resent):
        require(status == 200, f"(e) re-sent question {i} failed: {status}")
        if i in gaps:
            gap = gaps[i]
            require(gap <= 0.05, f"(e) question {i} alone gives {text}, in the sweep "
                                 f"{s1['replies'][i]}; the top two choices are {gap:.4f} apart")
            tie_notes.append(f"q{i} differs at a {gap:.4f} gap")
    require(s1["launches"]["paged_attention"] == 0,
            f"(e) the constrained sweep went through the batcher: {s1['launches']}")
    for i, reply in enumerate(s2["replies"]):
        require(reply != ERROR_SENTINEL and len(reply.split()) == SWEEP["max_tokens"],
                f"(e) free-text reply {i}: {reply!r}")
    require(s2["launches"]["paged_attention.tensor_core"] > 0,
            f"(e) sweep 2 never launched K7a's tensor-core path: {s2['launches']}")
    greedy_notes = []
    for i in range(SWEEP["check"]):
        ids = tok.encode(render_chat_prompt(msgs[i]), add_special_tokens=True)
        got = [int(t) for t in s2["replies"][i].split()]
        want = engine.generate([ids], max_new_tokens=SWEEP["max_tokens"], eos_id=tok.eos_id)[0]
        div = first_divergence(engine, ids, got, want)
        require(div is None or div[1] <= 0.05,
                f"(e) free-text reply {i} first differs from engine.generate at step {div}")
        greedy_notes.append("identical" if div is None else
                            f"differs at step {div[0]} (gap {div[1]:.4f})")
    # the driver's count of used memory against the allocator's: an
    # independent reading. The peak and the least used card below read the
    # counters housekeeping reads, so they only exercise its API.
    card_total = torch.cuda.get_device_properties(0).total_memory
    for sweep in (s1, s2):
        st = sweep["stats"]
        require(st["bytes_in_use"] <= sweep["reserved"] <= sweep["used"]
                <= sweep["reserved"] + 4 * 2**30 and st["bytes_limit"] == card_total,
                f"(e) housekeeping's {st} against the card's used {sweep['used']}, the "
                f"allocator's reserved {sweep['reserved']} and total {card_total}")
        require(st["peak_bytes_in_use"] == sweep["peak"],
                f"(e) housekeeping's peak {st} != max_memory_allocated {sweep['peak']}")
    require(housekeeping.get_less_used_device() == 0, "(e) the least used card is not 0")

    n = SWEEP["questions"]
    ttft = np.array(s2["ttft"]) * 1e3
    nofile = resource.getrlimit(resource.RLIMIT_NOFILE)
    print(f"[gen-e] MCQ sweep, {n} questions of {min(n_prompt)}-{max(n_prompt)} tokens (mean "
          f"{np.mean(n_prompt):.0f}) through the port's client, connector_limit 512 "
          f"(RLIMIT_NOFILE {nofile[0]}) | sweep 1 structured: {s1['wall']:.2f} s, "
          f"{n / s1['wall']:.2f} requests/s, {s1['inflight']} requests in the server at once, "
          f"peak {s1['peak'] / 2**30:.2f} GiB, re-sent {SWEEP['resend']} one at a time: "
          f"{'; '.join(tie_notes) or 'identical'} | sweep 2 free text ({SWEEP['max_tokens']} "
          f"tokens, {SWEEP['slots']} slots of {SWEEP['max_seq_len']}): {s2['wall']:.2f} s, "
          f"{n / s2['wall']:.2f} requests/s, {s2['inflight']} in the server at once, prompt "
          f"{sum(n_prompt) / (ttft.max() / 1e3):.0f} tokens/s (to the last first token), decode "
          f"{s2['tokens'] / s2['decode_s'] if s2['decode_s'] else 0.0:.1f} tokens/s "
          f"({1e3 * s2['decode_s'] / max(s2['steps'], 1):.1f} ms a step), TTFT p50 "
          f"{np.percentile(ttft, 50):.0f} ms p95 {np.percentile(ttft, 95):.0f} ms, peak "
          f"{s2['peak'] / 2**30:.2f} GiB; the card's used memory beyond the allocator's "
          f"reserved {(s1['used'] - s1['reserved']) / 2**30:.2f} / "
          f"{(s2['used'] - s2['reserved']) / 2**30:.2f} GiB; greedy vs engine.generate: {'; '.join(greedy_notes)} "
          f"| run (e) {time.perf_counter() - t_run:.1f} s in all | {card}", flush=True)
    launches = {k: s1["launches"][k] + s2["launches"][k] for k in s2["launches"]}
    print(f"[gen-e] launches {json.dumps(launches)}", flush=True)
    return launches


def phase_generation(torch, seed: int, card: str):
    """Full-width gemma-3-27b served over HTTP: runs (a), (e), (b), (c) and (d)."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import GemmaDecodeEngine, ModuloTokenizer
    from multimodal_colpali_tpu_torch.models.registry import load_gemma3_lm, tree_leaves

    rng = np.random.default_rng(seed)
    p = [mcq_prompt(rng, n) for n in PROMPT_TOKENS]

    def msg(text, **kw):
        return {"messages": [{"role": "user", "content": text}],
                "max_tokens": GEN["max_tokens"], **kw}

    sampling = dict(temperature=0.7, top_p=0.9, seed=seed + 7)
    greedy = [("greedy", msg(p[0])), ("greedy", msg(p[1], stream=True)), ("greedy", msg(p[4]))]
    requests = greedy[:2] + [("mcq", msg(p[2], response_format=MCQ_FORMAT)),
                             ("sampled", msg(p[3], **sampling)),
                             ("sampled", msg(p[3], **sampling)), greedy[2]]
    bf16 = torch.bfloat16

    t0 = time.perf_counter()
    cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed)
    engine = GemmaDecodeEngine(cfg, params, dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(engine.params))
    tok = ModuloTokenizer(cfg.vocab_size)
    print(f"[gen] {GEN_MODEL} {n_params / 1e9:.2f}B params bf16 on the card in "
          f"{time.perf_counter() - t0:.1f} s ({torch.cuda.memory_allocated() / 2**30:.1f} GiB); "
          f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, {cfg.num_attention_heads}"
          f"/{cfg.num_key_value_heads} heads of {cfg.head_dim}, window {cfg.sliding_window}; "
          f"prompts "
          f"{[len(tok.encode(x)) for x in p]} tokens", flush=True)
    runs = {"a": serve_run(torch, engine, tok, "a", "native", requests, card)}
    require(runs["a"]["paged_attention.tensor_core"] > 0,
            f"(a) never launched K7a's tensor-core path: {runs['a']}")
    runs["e"] = mcq_sweep(torch, engine, tok, seed, card)
    runs["b"] = serve_run(torch, engine, tok, "b", "int8", greedy, card)
    require(runs["b"]["paged_attention_int8.tensor_core"] > 0,
            f"(b) never launched K7b's tensor-core path: {runs['b']}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed,
                                    weight_dtype="int8")
    engine = GemmaDecodeEngine(cfg, params, dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    print(f"[gen] {GEN_MODEL} int8 weights made leaf by leaf in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)", flush=True)
    runs["c"] = serve_run(torch, engine, tok, "c", "native", greedy, card)
    require(runs["c"]["int8_matmul_kn.decode"] > 0 and runs["c"]["int8_matmul_kn.prefill"] > 0
            and runs["c"]["int8_matmul_nk"] > 0,
            f"(c) never launched both of K8a's tiles and K8b: {runs['c']}")
    require(runs["c"]["paged_attention.tensor_core"] > 0,
            f"(c) never launched K7a's tensor-core path: {runs['c']}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed,
                                    weight_dtype="int4")
    engine = GemmaDecodeEngine(cfg, params, dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    require(engine.weight_dtype == "int4", "the int4 tree was not detected as int4")
    print(f"[gen] {GEN_MODEL} int4 weights (group 256) made leaf by leaf in "
          f"{time.perf_counter() - t0:.1f} s ({torch.cuda.memory_allocated() / 2**30:.1f} GiB)",
          flush=True)
    runs["d"] = serve_run(torch, engine, tok, "d", "native", greedy, card)
    require(runs["d"]["int4_matmul_kn.decode"] > 0 and runs["d"]["int4_matmul_kn.prefill"] > 0
            and runs["d"]["int8_matmul_nk"] > 0,
            f"(d) never launched both of K9's tiles and K8b: {runs['d']}")
    require(runs["d"]["int8_matmul_kn"] == 0, f"(d) ran a projection as int8: {runs['d']}")
    require(runs["d"]["paged_attention.tensor_core"] > 0,
            f"(d) never launched K7a's tensor-core path: {runs['d']}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


IMG = dict(slots=4, max_seq_len=6144, chunk=8, page=16, max_tokens=32)
QUESTION = "Which binding constant do these pages report for sialyl Lewis x? Answer briefly."


def check_greedy(tag: str, key: str, got, want, gap_at, n: int = IMG["max_tokens"]) -> str:
    """A greedy reply of ``n`` tokens against the isolated engine's:
    identical, or first different where the engine's top two logits are
    within 0.05 (``gap_at(step)``)."""
    require(len(got) == n, f"[{tag}] {key}: {len(got)} tokens")
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        require(len(got) == len(want), f"[{tag}] {key}: {len(got)} tokens, the isolated "
                                       f"engine's {len(want)}")
        return f"{key}: identical"
    gap = gap_at(i)
    require(gap <= 0.05, f"[{tag}] {key} first differs from the isolated engine at step {i}, "
                         f"where its top two logits are {gap:.4f} apart (> 0.05)")
    return f"{key}: first differs at step {i} (top-2 gap {gap:.4f})"


def prefill_split(torch, mm, ids, pix):
    """One image prompt's prefill through ``mm`` split by CUDA events into
    the tower, the projector and the LM prefill (the merge into the text
    embeddings, every layer, the head's logits); the second of two runs.
    -> ms (tower, projector, LM prefill)."""
    from multimodal_colpali_tpu_torch.generation.engine import left_pad

    eng = mm.lm
    s = -(-len(ids) // 16) * 16
    tid, mask = (eng._tensor(a) for a in left_pad([ids], s, 0))
    pix = mm._pixels(pix)[None]
    with torch.inference_mode():
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            kc, vc = eng._caches(1, s)
            ev[0].record()
            vis = mm._tower(pix)
            ev[1].record()
            img = mm._project(vis, 1)
            ev[2].record()
            hidden, _, _ = mm._prefill_embeds(tid, mask, mm._merge(tid, img), kc, vc)
            eng._logits(eng.params, hidden[:, -1])
            ev[3].record()
            torch.cuda.synchronize()
            del kc, vc, vis, img, hidden
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def image_run(torch, mm, tok, tag: str, pix, text_prompts, card: str, conf=None, asks=None):
    """One run of phase 7 or 8: greedy image requests (``asks``: (key, image
    count, question), the first ``n`` images of ``pix`` each) and two text
    requests submitted at once to the paged batcher with ``mm`` (``conf``
    sizes it, its ``marks`` go to ``build_mm_prompt``), then an MCQ scored
    over all of ``pix`` through ``next_token_logits``, and the largest image
    prompt's prefill split into tower, projector and LM. With the batcher's
    ``prefix_caching`` on in ``conf``, the requests after the first over the
    same images must prefill only their tails. Returns the launch counts."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import PagedContinuousBatcher
    from multimodal_colpali_tpu_torch.generation.scheduler import _pixel_digest

    conf = conf or IMG
    prefix_caching = conf.get("prefix_caching", False)
    asks = asks or [("1 page", 1, QUESTION), (f"{TOP_K} pages", TOP_K, QUESTION)]
    wrappers = kernel_wrappers()
    eng = mm.lm
    newline = tok.encode("\n")

    marks = conf.get("marks", {})

    def prompt(question, n):
        return mm.build_mm_prompt(tok.encode(question), bos_id=tok.bos_id, newline_ids=newline,
                                  n_images=n, **marks)

    img = {key: (prompt(q, n), pix[:n]) for key, n, q in asks}
    txt = {f"text {i}": tok.encode(p, add_special_tokens=True) for i, p in enumerate(text_prompts)}
    bat = PagedContinuousBatcher(eng, batch_slots=conf["slots"], max_seq_len=conf["max_seq_len"],
                                 chunk=conf["chunk"], page_size=conf["page"], mm_engine=mm,
                                 eos_id=tok.eos_id, prefix_caching=prefix_caching)
    # warm-up at the requests' shapes on other pixels, one character of each
    # question and the first text token changed, so neither the prefill
    # cache nor the prefix pages serve the requests later
    warm_pix = pix * 0.5
    bat.generate([prompt(q.replace("?", "!"), n) for _, n, q in asks]
                 + [ids[:1] + [ids[1] + 1] + ids[2:] for ids in txt.values()],
                 max_new_tokens=2, pixel_values=[warm_pix[:n] for _, n, _ in asks]
                 + [None] * len(txt))
    torch.cuda.synchronize()
    # the image requests' tail-only prefills, each with the pages it reused:
    # the batcher's own counters also count text prompts that share a page
    image_tails = []
    tail_prefill = bat._prefix_prefill

    def spy(prompt_eff, ctx, mm_request):
        out = tail_prefill(prompt_eff, ctx, mm_request)
        if mm_request and out is not None:
            image_tails.append(out[4][1])
        return out

    bat._prefix_prefill = spy
    bat.decode_s, bat.decode_steps, bat.decode_tokens = 0.0, 0, 0
    bat.prefix_cache_hits = bat.prefix_prefill_hits = 0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    first, futs = {}, {}
    t0 = time.perf_counter()
    for key, (ids, p) in [*img.items(), *((k, (v, None)) for k, v in txt.items())]:
        futs[key] = bat.submit(ids, max_new_tokens=conf["max_tokens"], pixel_values=p,
                               on_token=lambda _, k=key, t=time.perf_counter(): first.setdefault(
                                   k, time.perf_counter() - t))
    bat.drain()
    wall = time.perf_counter() - t0
    got = {k: f.result(timeout=60) for k, f in futs.items()}
    scaffold = asks[-1][2] + '\n{"answer": "'
    n_scaffold = len(tok.encode(scaffold))
    firsts = [tok.encode(scaffold + c)[n_scaffold] for c in "ABCD"]
    mcq_ids = mm.build_mm_prompt(tok.encode(scaffold), bos_id=tok.bos_id, n_images=len(pix),
                                 **marks)
    t1 = time.perf_counter()
    logits = mm.next_token_logits([mcq_ids], pix[None])[0]
    mcq_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode = (bat.decode_tokens, bat.decode_s, bat.decode_steps)
    hits = (bat.prefix_cache_hits, bat.prefix_prefill_hits)
    del bat
    gc.collect()
    torch.cuda.empty_cache()
    require(logits.shape == (mm.cfg.text.vocab_size,) and bool(np.isfinite(logits).all()),
            f"[{tag}] MCQ logits: shape {logits.shape}, not all finite")
    answer = "ABCD"[int(np.argmax(logits[firsts]))]
    if prefix_caching:
        shared = sum(n == len(pix) for _, n, _ in asks) - 1
        # a tail-only image prefill holds no image token in its tail: every
        # image span came from the cached pages
        require(len(image_tails) >= shared,
                f"[{tag}] {len(image_tails)} image requests prefilled only their tails, not "
                f"the {shared} that share the first's images")

    # the isolated engines, each step's top-two logit gap recorded as it decodes
    notes = []
    eng.record_top2 = True
    for key, (ids, p) in [*img.items(), *((k, (v, None)) for k, v in txt.items())]:
        want = (eng.generate([ids], max_new_tokens=conf["max_tokens"], eos_id=tok.eos_id)
                if p is None else mm.generate([ids], p[None], max_new_tokens=conf["max_tokens"],
                                              eos_id=tok.eos_id))[0]
        gaps = eng.top2_gaps[0]
        notes.append(check_greedy(tag, key, got[key], want, lambda i, g=gaps: float(g[i])))
    eng.record_top2 = False
    key, (ids, p) = max(img.items(), key=lambda kv: len(kv[1][1]))
    split = prefill_split(torch, mm, ids, p)
    t1 = time.perf_counter()
    _pixel_digest(torch.from_numpy(np.ascontiguousarray(p)))
    digest_ms = (time.perf_counter() - t1) * 1e3
    tokens, secs, steps = decode
    print(f"[{tag}] {eng.weight_dtype} LM weights: image requests "
          f"({', '.join(f'{k}: {len(v[0])} tokens' for k, v in img.items())}) and text requests "
          f"({', '.join(f'{len(v)} tokens' for v in txt.values())}) submitted at once, in that "
          f"order, served in {wall:.2f} s | TTFT ms "
          f"{ {k: round(v * 1e3, 1) for k, v in first.items()} } | decode "
          f"{tokens / secs:.1f} tokens/s over {conf['slots']} slots, "
          f"{1e3 * secs / max(steps, 1):.1f} ms a step | MCQ over {len(pix)} images: {answer!r} "
          f"in {mcq_ms:.1f} ms | peak {peak:.1f} GiB | prefix pages reused {hits[0]}, tail-only "
          f"prefills {hits[1]}, of them image requests' {len(image_tails)} (pages reused "
          f"{image_tails}) | greedy vs the isolated engines: {'; '.join(notes)} | {card}",
          flush=True)
    print(f"[{tag}] {key} prefill by CUDA events: tower {split[0]:.1f} ms, projector "
          f"{split[1]:.2f} ms, LM prefill ({len(ids)} tokens) {split[2]:.1f} ms; pixel digest "
          f"{digest_ms:.1f} ms on the host | {card}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    return launches


def phase_images(torch, seed: int, card: str, checkpoint: dict, top_pages):
    """Phase 7: image-context serving at full width on the weights of
    phase 3's checkpoint (reloaded): ``PaliGemmaEngine`` on the retriever's
    own tower and projector, its LM the text engine's, in the paged batcher;
    run (a) with bf16 LM weights, run (b) with int8."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        GemmaDecodeEngine, ModuloTokenizer, PaliGemmaEngine)
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_state_dict

    bf16 = torch.bfloat16
    retr = load_retriever(COLPALI, device="cuda", dtype=bf16, checkpoint_dir=checkpoint["path"])
    cfg = retr.model.cfg
    pages = synthetic_pages(N_PAGES, cfg.vision.image_size, seed)
    pix = retr.processor.image_preprocessor([pages[i] for i in top_pages])   # [5, H, W, 3]
    tok = ModuloTokenizer(cfg.text.vocab_size)
    rng = np.random.default_rng(seed + 11)
    text_prompts = [mcq_prompt(rng, 300), mcq_prompt(rng, 700)]
    runs = {}
    for tag, weight_dtype in (("a", "native"), ("b", "int8")):
        engine = GemmaDecodeEngine(cfg.text, engine_params_from_state_dict(retr.model.state_dict()),
                                   dtype=bf16, weight_dtype=weight_dtype, device="cuda")
        mm = PaliGemmaEngine(retr.model, lm=engine)
        runs[tag] = image_run(torch, mm, tok, f"img-{tag}", pix, text_prompts, card)
        del mm, engine
        gc.collect()
        torch.cuda.empty_cache()
    del retr
    gc.collect()
    torch.cuda.empty_cache()
    for tag in ("a", "b"):
        require(runs[tag]["attention.tensor_core"] > 0 and runs[tag]["paged_attention.tensor_core"] > 0,
                f"(img-{tag}) never launched K2's or K7a's tensor-core path: {runs[tag]}")
    require(runs["b"]["int8_matmul_kn.decode"] > 0 and runs["b"]["int8_matmul_kn.prefill"] > 0
            and runs["b"]["int8_matmul_nk"] > 0,
            f"(img-b) never launched both of K8a's tiles and K8b: {runs['b']}")
    require(runs["a"]["int8_matmul_kn"] == 0, f"(img-a) ran a projection as int8: {runs['a']}")
    return runs


# Gemma-3's <start_of_image> and <end_of_image> around each image, as its chat
# template writes them: each image is then its own span of 256 tokens, which
# prefix caching requires (adjacent spans without them form one run)
G3_IMG = dict(slots=4, max_seq_len=2048, chunk=8, page=16, max_tokens=32, prefix_caching=True,
              marks=dict(boi_id=255_999, eoi_id=256_000))
# both questions over the 5 images open with one preamble, so the page after
# the image spans is shared too and the second question's tail holds no image
PREAMBLE = "Answer from the page images above, citing the page. "
G3_ASKS = [("1 image", 1, PREAMBLE + QUESTION),
           (f"{TOP_K} images", TOP_K, PREAMBLE + QUESTION),
           (f"{TOP_K} images, 2nd question", TOP_K,
            PREAMBLE + "Which figure shows the rolling velocity under shear? Answer briefly.")]


def phase_gemma3_images(torch, seed: int, card: str):
    """Phase 8: ``google/gemma-3-27b-it`` with images at full width and depth
    (random weights from ``seed`` through ``load_gemma3_mm``): the text
    engine and a ``Gemma3MMEngine`` on its LM in the paged batcher with
    prefix caching; run (a) bf16 LM weights, run (b) int8 made leaf by leaf
    on the card."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        Gemma3MMEngine, GemmaDecodeEngine, ModuloTokenizer)
    from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor
    from multimodal_colpali_tpu_torch.models.registry import load_gemma3_mm, tree_leaves

    bf16 = torch.bfloat16
    rng = np.random.default_rng(seed + 13)
    text_prompts = [mcq_prompt(rng, 300), mcq_prompt(rng, 700)]
    runs = {}
    for tag, weight_dtype in (("a", "native"), ("b", "int8")):
        t0 = time.perf_counter()
        cfg, params, _ = load_gemma3_mm(GEN_MODEL, device="cuda", dtype=bf16, seed=seed,
                                        weight_dtype=weight_dtype)
        tower, projector = params.pop("vision_tower"), params.pop("multi_modal_projector")
        engine = GemmaDecodeEngine(cfg.text, params, dtype=bf16, device="cuda")
        mm = Gemma3MMEngine(cfg, tower, projector, lm=engine)
        torch.cuda.synchronize()
        require(engine.weight_dtype == weight_dtype,
                f"[g3-{tag}] the LM is {engine.weight_dtype}, not {weight_dtype}")
        n_lm = sum(t.numel() for _, t in tree_leaves(engine.params))
        n_tower = sum(p.numel() for p in tower.parameters())
        # 896 x 896 pages: the preprocessor normalizes them without a resize
        pages = synthetic_pages(TOP_K, cfg.vision.image_size, seed)
        pix = ImagePreprocessor(cfg.vision.image_size)(pages)              # [5, 896, 896, 3]
        tok = ModuloTokenizer(cfg.text.vocab_size)
        print(f"[g3-{tag}] {GEN_MODEL} with images: LM {weight_dtype} ({n_lm / 1e9:.2f}B "
              f"elements), SigLIP-So400m {n_tower / 1e9:.3f}B params bf16 at "
              f"{cfg.vision.image_size} px ({cfg.vision.num_patches} patches, "
              f"{cfg.mm_tokens_per_image} soft tokens an image) made in "
              f"{time.perf_counter() - t0:.1f} s ({torch.cuda.memory_allocated() / 2**30:.1f} "
              f"GiB)", flush=True)
        runs[tag] = image_run(torch, mm, tok, f"g3-{tag}", pix, text_prompts, card,
                              conf=G3_IMG, asks=G3_ASKS)
        del mm, engine, tower, projector, params
        gc.collect()
        torch.cuda.empty_cache()
    for tag in ("a", "b"):
        require(runs[tag]["attention.tensor_core"] > 0
                and runs[tag]["paged_attention.tensor_core"] > 0,
                f"(g3-{tag}) never launched K2's or K7a's tensor-core path: {runs[tag]}")
    require(runs["b"]["int8_matmul_kn.decode"] > 0 and runs["b"]["int8_matmul_kn.prefill"] > 0
            and runs["b"]["int8_matmul_nk"] > 0,
            f"(g3-b) never launched both of K8a's tiles and K8b: {runs['b']}")
    require(runs["a"]["int8_matmul_kn"] == 0, f"(g3-a) ran a projection as int8: {runs['a']}")
    return runs


BGE = "BAAI/bge-base-en-v1.5"
# 4,096 chunks of 64-512 tokens (the chunker's range, max 512) embedded in
# batches of 64; a corpus of 100,000 chunks (~500 papers of ~200) over 4
# users; the Glycan benchmark's 120 questions, top-5
DENSE = dict(chunks=4096, batch=64, corpus=100_000, users=4, questions=120, top_k=5,
             f32_rows=64, self_rows=16, roundtrip=5, near_tie=1e-5)


def bert_hf_tensors(cfg):
    """(name, shape) of every tensor of a ``BertModel`` checkpoint (bge-base)
    as transformers saves it, in its order, the pooler included."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    out = [("embeddings.word_embeddings.weight", (cfg.vocab_size, h)),
           ("embeddings.position_embeddings.weight", (cfg.max_position_embeddings, h)),
           ("embeddings.token_type_embeddings.weight", (cfg.type_vocab_size, h)),
           ("embeddings.LayerNorm.weight", (h,)), ("embeddings.LayerNorm.bias", (h,))]
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            out += [(p + f"attention.self.{name}.weight", (h, h)),
                    (p + f"attention.self.{name}.bias", (h,))]
        out += [(p + "attention.output.dense.weight", (h, h)),
                (p + "attention.output.dense.bias", (h,)),
                (p + "attention.output.LayerNorm.weight", (h,)),
                (p + "attention.output.LayerNorm.bias", (h,)),
                (p + "intermediate.dense.weight", (inter, h)),
                (p + "intermediate.dense.bias", (inter,)),
                (p + "output.dense.weight", (h, inter)), (p + "output.dense.bias", (h,)),
                (p + "output.LayerNorm.weight", (h,)), (p + "output.LayerNorm.bias", (h,))]
    return out + [("pooler.dense.weight", (h, h)), ("pooler.dense.bias", (h,))]


def bert_norm(name: str):
    """A BERT LayerNorm at its identity (weight 1, bias 0); None otherwise."""
    if name.endswith("LayerNorm.weight"):
        return 1.0
    return 0.0 if name.endswith("LayerNorm.bias") else None


def check_bert_leaves(torch, model, cfg, path: str):
    """Parameters across the embeddings and the first and last layers must
    equal the file's tensors after the converter's transposes. -> their names."""
    from multimodal_colpali_tpu_torch.models import hf_import
    from multimodal_colpali_tpu_torch.models.convert import params_from_flax

    state = params_from_flax(hf_import.bert_params_from_hf(
        hf_import.load_state_dict(path), cfg), cfg)
    last = cfg.num_hidden_layers - 1
    names = ["word_embeddings", "position_embeddings", "token_type_embeddings",
             "embeddings_layernorm.weight", "layers.0.attention.query.weight",
             "layers.0.attention.key.bias", f"layers.{last}.intermediate.weight",
             f"layers.{last}.output_layernorm.bias"]
    params = dict(model.named_parameters())
    for name in names:
        got = params[name].detach().cpu()
        require(torch.equal(got, state[name].to(got.dtype)),
                f"{name} on the card differs from the checkpoint's tensor")
    return names


def synthetic_chunks(n: int, seed: int, lo: int = 64, hi: int = 512):
    """``n`` texts of ``lo``-``hi`` tokens (uniform, [CLS] and [SEP] counted),
    words drawn from a synthetic vocabulary of 20,000 lowercase words: the
    hash tokenizer gives one token a word."""
    import numpy as np

    rng = np.random.default_rng(seed + 9)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, int(k))) for k in rng.integers(3, 11, size=20_000)]
    lens = rng.integers(lo, hi + 1, size=n) - 2
    return [" ".join(vocab[j] for j in rng.integers(0, len(vocab), size=int(m))) for m in lens]


class TimedEmbeddings:
    """An embeddings object's surface that times its calls: the seconds of
    the last ``embed_documents`` and its vectors (the embedding pass inside
    ``qdrant_process``), and the seconds ``embed_query`` adds up (the
    embedding share of a similarity search)."""

    def __init__(self, emb):
        self.emb, self.query_s, self.documents_s, self.documents = emb, 0.0, 0.0, None

    def embed_documents(self, texts, batch_size: int = 64):
        t0 = time.perf_counter()
        self.documents = self.emb.embed_documents(texts, batch_size=batch_size)
        self.documents_s = time.perf_counter() - t0
        return self.documents

    def embed_query(self, text: str):
        t0 = time.perf_counter()
        v = self.emb.embed_query(text)
        self.query_s += time.perf_counter() - t0
        return v


def phase_dense(torch, seed: int, card: str, work: str) -> dict:
    """Phase 9: the dense RAG modes at full width, bf16 (``BAAI/bge-base-en-v1.5``
    = BERT-base; random values from ``seed`` in a bf16 HF checkpoint under
    ``work``). -> the kernel launches of (b)-(e): none may rise."""
    import os
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.documents import Document, make_metadata
    from multimodal_colpali_tpu_torch.models.bert import BertEncoder
    from multimodal_colpali_tpu_torch.models.configs import BertConfig
    from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings
    from multimodal_colpali_tpu_torch.store import (
        FieldCondition, Filter, MatchValue, PointStruct, VectorClient)

    d = DENSE
    cfg = BertConfig.bge_base()
    wrappers = kernel_wrappers()
    t_phase = time.perf_counter()
    # (a) a bf16 HF checkpoint, loaded through checkpoint_dir=
    ckpt_dir = os.path.join(work, "bge-ckpt")
    os.makedirs(ckpt_dir)
    ckpt = write_checkpoint(torch, bert_hf_tensors(cfg), ckpt_dir, seed, 1, "cuda",
                            norm=bert_norm)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        emb = BgeEmbeddings(BGE, cfg=cfg, checkpoint_dir=ckpt_dir, device="cuda")
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(not any("random init" in str(w.message) for w in caught),
            f"{BGE}: the checkpoint at {ckpt_dir} was not loaded")
    leaves = check_bert_leaves(torch, emb.model, cfg, ckpt_dir)
    shutil.rmtree(ckpt_dir)
    n_params = sum(p.numel() for p in emb.model.parameters())
    print(f"[dense] {BGE}: a bf16 HF checkpoint of {ckpt['bytes'] / 1e6:.1f} MB written in "
          f"{ckpt['write_s']:.2f} s, BgeEmbeddings(checkpoint_dir=) {load_s:.2f} s, "
          f"{n_params / 1e6:.1f}M parameters, {len(leaves)} leaves equal the file's | {card}",
          flush=True)

    # (b) + (c): the chunks through qdrant_process, whose one embed_documents
    # pass (batch 64) is timed and gated
    users = [f"user{u}" for u in range(d["users"])]
    img_dir = Path(work) / "figures"
    img_dir.mkdir()
    figures = []
    for k in range(8):
        figures.append(str(img_dir / f"fig{k}.bin"))
        Path(figures[-1]).write_bytes(f"figure {k}\n".encode() * 64)
    chunks = synthetic_chunks(d["chunks"], seed)
    docs = []
    for i, text in enumerate(chunks):
        is_fig = i % 8 == 7        # a VLM summary of a figure (multimodal RAG)
        meta = make_metadata(f"paper{i // 200:03d}.pdf", f"doc{i}", type=(
            "image" if is_fig else "text"), page_no=1 + i % 12,
            img_link=figures[i // 8 % 8] if is_fig else "")
        meta["username"] = users[i % d["users"]]
        docs.append(Document(text, meta))
    n_tokens = sum(len(c.split()) + 2 for c in chunks)   # a token a word, [CLS], [SEP]
    emb.embed_documents(chunks[: d["batch"]], batch_size=d["batch"])   # warm-up
    store_dir = os.path.join(work, "vector-db")
    client = VectorClient(store_dir, device="cuda")
    coll = "text_vd"
    timed = TimedEmbeddings(emb)
    tokenize, tokenize_s = emb._tokenize, [0.0]

    def timed_tokenize(texts, bucket=32):     # the host's share of embed_documents
        t0 = time.perf_counter()
        out = tokenize(texts, bucket)
        tokenize_s[0] += time.perf_counter() - t0
        return out

    emb._tokenize = timed_tokenize
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    api.qdrant_process(docs, client, coll, cfg.hidden_size, timed)
    process_s = time.perf_counter() - t0
    del emb._tokenize
    embed_s = timed.documents_s
    vecs = np.asarray(timed.documents, np.float32)
    require(vecs.shape == (d["chunks"], cfg.hidden_size) and bool(np.isfinite(vecs).all()),
            f"embed_documents gave {vecs.shape}")
    norms = np.linalg.norm(vecs, axis=-1)
    require(bool(np.all(np.abs(norms - 1) <= 1e-3)),
            f"embeddings not unit-norm: {norms.min()}..{norms.max()}")
    rows = np.arange(d["f32_rows"]) * (d["chunks"] // d["f32_rows"])
    f32 = BertEncoder(cfg, device="cuda", dtype=torch.float32)
    f32.load_state_dict(emb.model.state_dict())
    ids, mask = emb._tokenize([chunks[i] for i in rows])
    with torch.inference_mode():
        ref = f32(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu().numpy()
    del f32
    cos = np.sum(ref * vecs[rows], -1) / np.linalg.norm(ref, axis=-1) / norms[rows]
    require(cos.min() >= 0.995, f"bf16 embeddings against float32: cosine {cos.min():.5f}")
    print(f"[dense] embed_documents: {d['chunks']} chunks of 64-512 tokens (batch "
          f"{d['batch']}) in {embed_s:.2f} s = {d['chunks'] / embed_s:.1f} chunks/s, "
          f"{n_tokens / embed_s:.0f} tokens/s unpadded (host tokenization "
          f"{tokenize_s[0]:.2f} s of it); unit norms within "
          f"{np.abs(norms - 1).max():.2e}; cosine with a float32 forward on {len(rows)} "
          f"chunks >= {cos.min():.6f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB | {card}", flush=True)

    # (c) synthetic unit vectors fill the collection to 100,000 chunks
    rng = np.random.default_rng(seed + 11)
    n_syn = d["corpus"] - d["chunks"]
    syn = rng.standard_normal((n_syn, cfg.hidden_size), dtype=np.float32)
    syn /= np.linalg.norm(syn, axis=-1, keepdims=True)
    points = [PointStruct(id=f"syn-{j}", vector=syn[j], payload={
        "page_content": f"synthetic chunk {j}",
        "metadata": {"document_name": f"paper{(d['chunks'] + j) // 200:03d}.pdf",
                     "type": "text", "img_link": "", "page_no": 1 + j % 12,
                     "username": users[(d["chunks"] + j) % d["users"]]}})
        for j in range(n_syn)]
    t0 = time.perf_counter()
    client.upsert(coll, points)
    upsert_s = time.perf_counter() - t0
    del points, syn
    require(client.count(coll).count == d["corpus"], "the collection does not hold every chunk")

    # (d) 120 questions: embed, search without and with the filter, the prompt functions
    store = api.TpuVectorStore(client, coll, timed)
    questions = [" ".join(c.split()[:12]) + "?" for c in synthetic_chunks(
        d["questions"], seed + 1, lo=14, hi=14)]
    store.similarity_search_with_score(questions[0], d["top_k"])       # warm-up: the upload
    dense_store = client._get(coll)
    corpus = dense_store._device_cache
    host_vecs = torch.from_numpy(dense_store._vectors).cuda().to(torch.bfloat16).float()
    device_mb = corpus.numel() * corpus.element_size() / 1e6
    embed_ms, plain_ms, filt_ms, prep_ms, first = [], [], [], [], []
    near_ties = 0
    for qi, question in enumerate(questions):
        user = users[qi % d["users"]]
        flt = Filter(must=[FieldCondition(key="metadata.username", match=MatchValue(value=user))])
        t0 = time.perf_counter()
        qv = emb.embed_query(question)
        t1 = time.perf_counter()
        res = client.query_points(coll, query=qv, limit=d["top_k"])
        t2 = time.perf_counter()
        timed.query_s = 0.0
        hits = store.similarity_search_with_score(question, d["top_k"], filter=flt)
        t3 = time.perf_counter()
        built = api.prompt_prep_query(question, "Answer from the context: {query}", client,
                                      user, coll, emb, d["top_k"], type="mm_RAG")
        t4 = time.perf_counter()
        embed_ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
        filt_ms.append((t3 - t2 - timed.query_s) * 1e3)
        prep_ms.append((t4 - t3) * 1e3)
        first.append(res)
        # gate 3: the top-5 of a float32 product of the same bf16 corpus, stable order
        q = np.asarray(qv, np.float32)
        q = torch.from_numpy(q / max(np.linalg.norm(q), 1e-12)).cuda().to(torch.bfloat16)
        ref = host_vecs @ q.float()
        order = torch.argsort(-ref, stable=True)[: d["top_k"]].tolist()
        got = [dense_store._id_to_idx[p.id] for p in res.points]
        for a, b in zip(got, order):
            if a != b:
                require(abs(float(ref[a]) - float(ref[b])) < d["near_tie"],
                        f"question {qi}: top-{d['top_k']} {got} against the float32 "
                        f"product's {order} beyond near-ties")
                near_ties += 1
        # gate 5: the filter
        require(len(hits) == d["top_k"] and all(doc.metadata["username"] == user
                                               for doc, _ in hits),
                f"question {qi}: the filtered search returned another user's chunk")
        require([doc.page_content for doc, _ in built["context"]]
                == [doc.page_content for doc, _ in hits] and
                len(built["q_prompts"]) == d["top_k"],
                f"question {qi}: prompt_prep_query(type='mm_RAG') differs from the search")
        for (doc, _), msgs in zip(hits, built["q_prompts"]):
            kinds = [part["type"] for part in msgs[0]["content"]]
            require(kinds == (["text", "image_url"] if doc.metadata["type"] == "image"
                              else ["text"]), f"question {qi}: prompt parts {kinds}")
    none = api.prompt_prep_query(questions[0], "{query}", client, users[0], coll, emb,
                                 d["top_k"], type="")
    require(none["context"] == [] and none["q_prompts"] == [], "type='' built a context")
    # gate 4: chunks queried by their own text come back first
    self_rows = np.arange(d["self_rows"]) * (d["chunks"] // d["self_rows"]) + 3
    worst = 0.0
    for i in self_rows:
        top = store.similarity_search_with_score(chunks[i], d["top_k"])
        require(top[0][0].page_content == chunks[i] and abs(top[0][1] - 1) <= 5e-2,
                f"chunk {i} queried by its own text: first {top[0][0].page_content[:40]!r} "
                f"at {top[0][1]:.4f}")
        worst = max(worst, abs(top[0][1] - 1))
    print(f"[dense] corpus {d['corpus']} chunks x {cfg.hidden_size} ({d['users']} users): "
          f"qdrant_process of {d['chunks']} chunks {process_s:.2f} s (its embedding pass "
          f"included), "
          f"upsert of {n_syn} vectors {upsert_s:.2f} s, {device_mb:.1f} MB on the card "
          f"(bf16); {d['questions']} questions, ms a query: embed {np.mean(embed_ms):.2f} "
          f"(median {np.median(embed_ms):.2f}), search without a filter "
          f"{np.mean(plain_ms):.2f} (median {np.median(plain_ms):.2f}), search with the "
          f"filter {np.mean(filt_ms):.2f} (median {np.median(filt_ms):.2f}), "
          f"prompt_prep_query(mm_RAG) {np.mean(prep_ms):.2f}; top-{d['top_k']} equal to the "
          f"float32 product ({near_ties} near-ties), filter ok, {len(self_rows)} chunks "
          f"first by their own text within {worst:.2e} of 1; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}", flush=True)

    # (e) the round trip through the files
    t0 = time.perf_counter()
    client.save()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = VectorClient(store_dir, device="cuda")
    load_s = time.perf_counter() - t0
    for qi in range(d["roundtrip"]):
        qv = emb.embed_query(questions[qi])
        res = again.query_points(coll, query=qv, limit=d["top_k"])
        require([(p.id, p.score) for p in res.points]
                == [(p.id, p.score) for p in first[qi].points],
                f"question {qi}: the reloaded store gives other ids or scores")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    require(not any(launches.values()), f"the dense path launched a port kernel: {launches}")
    size = sum(f.stat().st_size for f in Path(store_dir).rglob("*") if f.is_file())
    print(f"[dense] VectorClient(path).save() {save_s:.2f} s ({size / 1e6:.1f} MB), "
          f"VectorClient(path) {load_s:.2f} s; {d['roundtrip']} queries bit-identical after "
          f"the reload; no port kernel launched; phase 9 took "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    del client, again, emb, store, corpus, host_vecs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_colqwen_leaves(torch, model, cfg, path: str):
    """Ten parameters across the tower, the merger, the LM and the head must
    equal the file's tensors after the converter's reshapes and transposes.
    -> their names."""
    from multimodal_colpali_tpu_torch.models import hf_import
    from multimodal_colpali_tpu_torch.models.convert import params_from_flax

    state = params_from_flax(hf_import.colqwen2_params_from_hf(
        hf_import.load_state_dict(path), cfg), cfg)
    lv, lt = cfg.vision.depth - 1, cfg.text.num_hidden_layers - 1
    names = ["visual.patch_embed.weight", "visual.blocks_0.qkv.weight",
             f"visual.blocks_{lv}.down_proj.bias", "visual.ln_q.weight",
             "visual.merger_fc2.weight", "embed_tokens", "layers.0.self_attn.k_proj.bias",
             f"layers.{lt}.down_proj.weight", "norm.weight", "embedding_proj_layer.weight"]
    params = dict(model.named_parameters())
    for name in names:
        got = params[name].detach().cpu()
        require(torch.equal(got, state[name].to(got.dtype)),
                f"{name} on the card differs from the checkpoint's tensor")
    return names


def phase_colqwen(torch, seed: int, card: str, ckpt_root: Path) -> dict:
    """Phase 11: ``vidore/colqwen2.5-v0.2`` at full width from a bf16 HF
    checkpoint written beside phase 3's (``ckpt_root``, kept for phase 12):
    16 synthetic pages at the 54 x 54 bucket in batches of 8, indexed through
    ``colpali_qdrant``, 4 queries through ``retrieve_colpali`` against
    ``score_results`` (the same top 5 up to near-ties), then 4 pages of two
    other sizes under ``dynamic_resolution``. K2 must run at both of the
    tower's shapes, every launch on its tensor-core path, K1 on the store's
    search. -> the launches, and K2's at each shape."""
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.models.processing_qwen2vl import ColQwen2Processor
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS, Retriever
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.store import VectorClient

    t_phase = time.perf_counter()
    cfg = RETRIEVER_CONFIGS[COLQWEN]()
    path = ckpt_root / COLQWEN.replace("/", "--")
    path.mkdir()
    ck = write_checkpoint(torch, colqwen_hf_tensors(cfg), str(path), seed, 4, "cuda",
                          norm=colqwen_norm)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, PeakRss() as host:
        warnings.simplefilter("always")
        retr = load_retriever(COLQWEN, device="cuda", dtype=torch.bfloat16, checkpoint_dir=str(path))
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(not any("random init" in str(w.message) for w in caught),
            f"{COLQWEN}: the checkpoint at {path} was not loaded")
    leaves = check_colqwen_leaves(torch, retr.model, cfg, str(path))
    n_params = sum(p.numel() for p in retr.model.parameters())
    print(f"[colqwen] {COLQWEN} {n_params / 1e9:.3f}B params: wrote a bf16 HF checkpoint of "
          f"{ck['bytes'] / 1e9:.2f} GB in {ck['files']} files in {ck['write_s']:.1f} s; "
          f"load_retriever(checkpoint_dir=) {load_s:.2f} s = {ck['bytes'] / 1e9 / load_s:.2f} "
          f"GB/s | host peak RSS growth {host.growth / 1e9:.2f} GB | {len(leaves)} leaves equal "
          f"the file's | {card}", flush=True)

    shapes = {}

    def recorded(orig):
        def run(q, k, v, kv_lens=None, kv_valid=None, **kw):
            key = (tuple(q.shape), "kv_lens" if kv_lens is not None else
                   "kv_valid" if kv_valid is not None else "none")
            shapes[key] = shapes.get(key, 0) + 1
            return orig(q, k, v, kv_lens, kv_valid, **kw)
        return run

    wrappers = kernel_wrappers()
    pages = synthetic_pages(QWEN["pages"], QWEN["size"], seed)
    b = QWEN["batch"]
    retr.embed_images(pages[:b], batch_size=b)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    # the tower's calls of the dispatcher, which launch K2 on a CUDA tensor
    with Patched(L, "fused_attention", recorded):
        t0 = time.perf_counter()
        embs = retr.embed_images(pages, batch_size=b)
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        fwd = QWEN["pages"] // b
        v = cfg.vision
        n_full = len(v.fullatt_block_indexes)
        want = {((b * 49, 64, v.num_heads, v.head_dim), "kv_lens"): (v.depth - n_full) * fwd,
                ((b, 3136, v.num_heads, v.head_dim), "kv_valid"): n_full * fwd}
        require(shapes == want, f"ColQwen2.5's tower launched K2 at {shapes}, not {want}")
        dim = cfg.embedding_dim
        for e in embs:
            require(e.shape == (embs[0].shape[0], dim) and bool(np.isfinite(e).all()),
                    f"embedding shape {e.shape} or non-finite values")
            require(bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                    "valid tokens are not unit-norm")
        client = VectorClient(device="cuda")
        api.ensure_colpali_collection(client, "qwen", vector_size=dim)
        dataset = [{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                    "img_link": ""} for i in range(len(pages))]
        api.colpali_qdrant(dataset, [], [], retr, retr.processor, client, "qwen", batch_size=b)
        api.retrieve_colpali("warm-up query", retr.processor, retr, client, "", "qwen", TOP_K)
        query_ms, retrieved = [], []
        for qtext in QUERIES:
            t0 = time.perf_counter()
            res = api.retrieve_colpali(qtext, retr.processor, retr, client, "", "qwen", TOP_K)
            query_ms.append((time.perf_counter() - t0) * 1e3)
            retrieved.append([(p.payload["document_name"], p.payload["page_no"])
                              for p in res.points])
        store = [{"embedding": embs[i], "doc_id": i // 4, "page_id": i % 4,
                  "file_name": f"doc{i // 4}.pdf"} for i in range(len(pages))]
        per_pdf = {f"doc{j}.pdf": pages[4 * j: 4 * j + 4] for j in range(len(pages) // 4)}
        scored = api.score_results(QUERIES, retr.processor, retr, store, per_pdf, TOP_K)
        full = retr.processor.score_multi_vector(retr.embed_queries(QUERIES), embs, device="cuda")
        index = {(f"doc{i // 4}.pdf", i % 4): i for i in range(len(pages))}
        exact = True
        for qi, (ret, sc) in enumerate(zip(retrieved, scored)):
            got = [(r["file_name"], r["page_id"]) for r in sc]
            require(len(ret) == TOP_K, f"query {qi}: retrieve_colpali returned {len(ret)} pages")
            exact &= ret == got
            for x, y in zip(ret, got):
                sa, sb = full[qi, index[x]], full[qi, index[y]]
                require(abs(sa - sb) <= 1e-2 * abs(sb) + 1e-2,
                        f"query {qi}: retrieve_colpali {ret} vs score_results {got} beyond ties")
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        qwen_k2 = dict(shapes)
        # dynamic resolution on the same weights: two grids, a group each
        dyn = Retriever(name=COLQWEN, model=retr.model, device=retr.device, dtype=retr.dtype,
                        family="colqwen2",
                        processor=ColQwen2Processor(cfg, tokenizer=retr.processor.tokenizer,
                                                    dynamic_resolution=True))
        half = QWEN["dyn_pages"] // 2
        dpages = [synthetic_pages(1, max(hw), seed + 20 + i)[0][:hw[0], :hw[1]]
                  for hw in QWEN["dyn"] for i in range(half)]
        grids = dyn.processor.group_by_grid(dpages)
        shapes.clear()
        t0 = time.perf_counter()
        dembs = dyn.embed_images(dpages, batch_size=b)
        torch.cuda.synchronize()
        dyn_s = time.perf_counter() - t0
    require(len(grids) == 2 and all(g != (cfg.grid_h, cfg.grid_w) for g, _ in grids),
            f"dynamic resolution gave the grids {grids}")
    m = cfg.vision.spatial_merge_size
    for (g, idxs) in grids:
        for i in idxs:
            n_tok = (g[0] // m) * (g[1] // m)
            require(dembs[i].shape[0] == embs[0].shape[0] - cfg.grid_h * cfg.grid_w // 4 + n_tok,
                    f"dynamic page {i} at grid {g}: {dembs[i].shape[0]} tokens")
            require(bool(np.isfinite(dembs[i]).all()), "non-finite dynamic embedding")
    require(launches["attention"] == launches["attention.tensor_core"] > 0
            and launches["maxsim"] > 0,
            f"ColQwen2.5: K2 off its tensor-core path, or no K1: {launches}")
    # every K2 launch came from the tower's dispatcher calls counted above
    require(sum(qwen_k2.values()) == launches["attention"],
            f"ColQwen2.5: K2's wrapper counted {launches['attention']} launches, the tower's "
            f"calls {sum(qwen_k2.values())}")
    require(sum(shapes.values()) == cfg.vision.depth * len(grids),
            f"dynamic resolution: K2 launches {shapes}")
    print(f"[colqwen] {QWEN['pages']} pages of {QWEN['size']} px (54 x 54 patches, "
          f"{embs[0].shape[0]} tokens) in batches of {b}: embed {QWEN['pages'] / embed_s:.2f} "
          f"pages/s; retrieve_colpali {np.mean(query_ms):.1f} ms/query (mean of "
          f"{', '.join(f'{t:.1f}' for t in query_ms)}); top-{TOP_K} vs score_results "
          f"{'identical' if exact else 'equal up to near-ties'}; K2 a forward: "
          f"{want[((b * 49, 64, v.num_heads, v.head_dim), 'kv_lens')] // fwd} window launches "
          f"[{b * 49}, 64, 16, 80] with kv_lens, {n_full} full [{b}, 3136, 16, 80] with "
          f"kv_valid, all on its tensor cores; dynamic resolution: "
          f"{QWEN['dyn_pages']} pages at grids {[g for g, _ in grids]} in {dyn_s:.2f} s "
          f"(K2 {dict((str(k[0]), n) for k, n in shapes.items())}); peak {peak:.1f} GiB; "
          f"phase 11 {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    print(f"[colqwen] launches {json.dumps(launches)}", flush=True)
    del retr, dyn, client
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches,
            "attention.colqwen_window": sum(n for (sh, kind), n in qwen_k2.items()
                                            if kind == "kv_lens"),
            "attention.colqwen_full": sum(n for (sh, kind), n in qwen_k2.items()
                                          if kind == "kv_valid")}


# phase 13: the rest of the reference's retriever grid. ColGranite: 16 square
# pages in batches of 8, then 4 pages of two aspects (h, w) under anyres in
# batches of 2 (about 3,000 image tokens a page: the LM's float32 attention
# scores are ~1.2 GB a page a layer); ColSmol with image splitting: 2 PDFs of
# 4 letter pages (5 sub-images a page at longest_edge 1,024); W8A8: phase 3's
# checkpoint and pages, and Gemma-3's 896-px tower over 5 images
GRANITE = "ibm-granite/granite-vision-3.3-2b-embedding"
COLSMOL = "vidore/colSmol-256M"
GRID = dict(pages=16, batch=8, size=384, anyres=((1100, 850), (600, 1000)), anyres_pages=4,
            anyres_batch=2, smol_pdfs=2, smol_pages=4, smol_batch=8, cos=0.98, g3_images=5,
            mlp=(8 * 1030, 2048, 16384))


def unit_rows(np, embs, n_tokens=None):
    """Each embedding finite, of ``n_tokens`` rows where given, unit-norm rows."""
    for e in embs:
        require(n_tokens is None or e.shape[0] == n_tokens,
                f"an embedding of {e.shape[0]} tokens, not {n_tokens}")
        require(bool(np.isfinite(e).all()), "non-finite embedding")
        require(bool(np.allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-3)),
                "valid tokens are not unit-norm")


def search_agrees(np, retr, embs, pages, client, collection: str, batch: int):
    """``colpali_qdrant`` of ``pages`` (``embs`` their embeddings) into
    ``collection``, ``QUERIES`` through ``retrieve_colpali`` against
    ``score_results``: the same top 5 up to near-ties of the full scores.
    The store holds bf16 pages and scores a bf16 query, so each of a query's
    n token maxima may move by 2^-7 (two roundings of unit vectors) and a
    page's score by n 2^-7: two pages may swap where their float32 scores
    are within n 2^-6. -> (ms a query, whether identical)."""
    from multimodal_colpali_tpu_torch import api

    dim = embs[0].shape[1]
    # the store keeps max_tokens rows a page (1,056 by default, as JAX's) and
    # drops the rest: ColGranite's square pages hold 1,489
    api.ensure_colpali_collection(client, collection, vector_size=dim,
                                  max_tokens=max(e.shape[0] for e in embs))
    dataset = [{"image": pages[i], "filename": f"doc{i // 4}.pdf", "page_no": i % 4,
                "img_link": ""} for i in range(len(pages))]
    api.colpali_qdrant(dataset, [], [], retr, retr.processor, client, collection,
                       batch_size=batch)
    api.retrieve_colpali("warm-up query", retr.processor, retr, client, "", collection, TOP_K)
    query_ms, retrieved = [], []
    for qtext in QUERIES:
        t0 = time.perf_counter()
        res = api.retrieve_colpali(qtext, retr.processor, retr, client, "", collection, TOP_K)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        retrieved.append([(p.payload["document_name"], p.payload["page_no"]) for p in res.points])
    store = [{"embedding": embs[i], "doc_id": i // 4, "page_id": i % 4,
              "file_name": f"doc{i // 4}.pdf"} for i in range(len(pages))]
    per_pdf = {f"doc{j}.pdf": pages[4 * j: 4 * j + 4] for j in range(len(pages) // 4)}
    scored = api.score_results(QUERIES, retr.processor, retr, store, per_pdf, TOP_K)
    q_embs = retr.embed_queries(QUERIES)
    full = retr.processor.score_multi_vector(q_embs, embs, device="cuda")
    index = {(f"doc{i // 4}.pdf", i % 4): i for i in range(len(pages))}
    exact, gap = True, 0.0
    for qi, (ret, sc) in enumerate(zip(retrieved, scored)):
        got = [(r["file_name"], r["page_id"]) for r in sc]
        require(len(ret) == TOP_K, f"query {qi}: retrieve_colpali returned {len(ret)} pages")
        exact &= ret == got
        tie = q_embs[qi].shape[0] * 2.0 ** -6
        for x, y in zip(ret, got):
            sa, sb = full[qi, index[x]], full[qi, index[y]]
            gap = max(gap, abs(sa - sb))
            require(abs(sa - sb) <= tie,
                    f"query {qi}: retrieve_colpali {ret} vs score_results {got}: float32 "
                    f"scores {sa:.4f} / {sb:.4f} beyond a bf16 tie ({tie:.3f})")
    return float(np.mean(query_ms)), exact, gap


class CallRecorder:
    """Wraps a kernel's entry point (``Patched``): counts its calls by the q
    shape and keeps the first call's arguments at each shape, for the
    kernel-against-plain checks after the run."""

    def __init__(self):
        self.shapes, self.inputs = {}, {}

    def __call__(self, orig):
        def run(q, *args, **kw):
            shape = tuple(q.shape)
            self.shapes[shape] = self.shapes.get(shape, 0) + 1
            if shape not in self.inputs:
                self.inputs[shape] = ([x.clone() if hasattr(x, "clone") else x
                                       for x in (q, *args)], dict(kw))
            return orig(q, *args, **kw)
        return run


def tower_k2_against_plain(torch, inputs: dict) -> dict:
    """K2 against its plain version on the q, k, v a tower gave it, one set
    at each shape (``inputs``: shape -> (q, k, v, kv_lens, kv_valid), kw).
    Activations of a random tower are not N(0, 1) as phase 2's are, so the
    bound is phase 2's ``K2_GRANITE_ATOL`` plus 2e-2 of the plain value (a
    bf16 output rounds by 2^-9 of itself). -> max|err| a shape."""
    from multimodal_colpali_tpu_torch.ops import attention as A

    errs = {}
    for shape, (args, kw) in sorted(inputs.items()):
        q, k, v, kv_lens, kv_valid = args
        got = A.fused_attention_cuda(q, k, v, kv_lens, kv_valid, **kw)
        want = torch.cat([A.attention_reference(
            q[i: i + 1], k[i: i + 1], v[i: i + 1], None,
            None if kv_lens is None else kv_lens[i: i + 1],
            None if kv_valid is None else kv_valid[i: i + 1], **kw) for i in range(q.shape[0])])
        err = float((got.float() - want.float()).abs().max())
        require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=K2_GRANITE_ATOL),
                f"K2 at the tower's {list(shape)}: max|err| {err} beyond atol "
                f"{K2_GRANITE_ATOL} + rtol 2e-2 (max|plain| {float(want.float().abs().max())})")
        errs[str(list(shape))] = float(f"{err:.3g}")
    return errs


def grid_granite(torch, seed: int, card: str) -> dict:
    """Phase 13 (a): ColGranite at full width, random bf16 weights made on the
    card. The square layout through ``colpali_qdrant``, ``retrieve_colpali``
    and ``score_results``; then anyres, one group a layout, each page's
    tokens ``n_image_tokens_for`` its layout. K2 on its tensor cores at the
    tower's shapes, K1 in the searches; K2 against its plain version on the
    tower's q, k, v at each shape. -> launches and K2's at [8, 729]."""
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.models.processing_granite import ColGraniteProcessor
    from multimodal_colpali_tpu_torch.models.registry import Retriever
    from multimodal_colpali_tpu_torch.store import VectorClient

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # random weights: the init warns
        retr = load_retriever(GRANITE, device="cuda", dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = retr.model.cfg
    n_params = sum(p.numel() for p in retr.model.parameters())
    rec = CallRecorder()        # K2's calls by shape, the first q, k, v at each
    shapes = rec.shapes

    wrappers = kernel_wrappers()
    b = GRID["batch"]
    pages = synthetic_pages(GRID["pages"], GRID["size"], seed + 30)
    retr.embed_images(pages[:b], batch_size=b)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    with Patched(L, "fused_attention", rec):
        t0 = time.perf_counter()
        embs = retr.embed_images(pages, batch_size=b)
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        n_tok = retr.processor.process_images(pages[:1])["input_ids"].shape[1]
        unit_rows(np, embs, n_tok)
        client = VectorClient(device="cuda")
        ms_query, exact, gap = search_agrees(np, retr, embs, pages, client, "granite", b)
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        square_k2 = dict(shapes)
        forwards = 2 * GRID["pages"] // b                 # embed_images, colpali_qdrant
        layers = cfg.feature_layers
        heads = cfg.vision.num_attention_heads
        head_dim = cfg.vision.hidden_size // heads
        want = {(b, cfg.grid ** 2, heads, head_dim): layers * forwards}
        require(square_k2 == want, f"ColGranite's tower launched K2 at {square_k2}, not {want}")
        # anyres on the same weights: one group a layout
        dyn = Retriever(name=GRANITE, model=retr.model, device=retr.device, dtype=retr.dtype,
                        family="colgranite",
                        processor=ColGraniteProcessor(cfg, tokenizer=retr.processor.tokenizer,
                                                      anyres=True))
        half = GRID["anyres_pages"] // 2
        dpages = [synthetic_pages(1, max(hw), seed + 40 + i)[0][:hw[0], :hw[1]]
                  for hw in GRID["anyres"] for i in range(half)]
        groups = dyn.processor.group_by_grid(dpages)
        dyn.embed_images(dpages[:1], batch_size=1)        # warm-up
        shapes.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dembs = dyn.embed_images(dpages, batch_size=GRID["anyres_batch"])
        torch.cuda.synchronize()
        dyn_s = time.perf_counter() - t0
        dyn_peak = torch.cuda.max_memory_allocated() / 2**30
        launches_all = read_counts(wrappers)
    require(len(groups) == 2, f"anyres gave the layouts {groups}")
    extra = n_tok - cfg.n_image_tokens
    for grid, idxs in groups:
        unit_rows(np, [dembs[i] for i in idxs], cfg.n_image_tokens_for(grid) + extra)
    tiles = [g[0] * g[1] for g, idxs in groups for _ in idxs]
    require(sum(shapes.values()) == layers * len(groups) and all(
        s[1:] == (cfg.grid ** 2, heads, head_dim) for s in shapes),
            f"anyres: K2 launches {shapes}")
    require(launches_all["attention"] == launches_all["attention.tensor_core"] > 0
            and launches["maxsim"] > 0 and launches["maxsim.tensor_core"] > 0,
            f"ColGranite: K2 off its tensor-core path, or no K1: {launches_all}")
    k2_errs = tower_k2_against_plain(torch, rec.inputs)
    print(f"[grid] (a) {GRANITE} {n_params / 1e9:.3f}B params bf16 (random init on the card "
          f"{init_s:.1f} s): {GRID['pages']} square pages of {GRID['size']} px ({n_tok} tokens, "
          f"{cfg.n_image_tokens} image) in batches of {b}: embed {GRID['pages'] / embed_s:.2f} "
          f"pages/s; retrieve_colpali {ms_query:.1f} ms/query; top-{TOP_K} vs score_results "
          f"{'identical' if exact else f'equal up to bf16 ties (largest gap {gap:.4f})'}; "
          f"K2 {want[next(iter(want))]} "
          f"launches at {list(next(iter(want)))} on its tensor cores; peak {peak:.1f} GiB | "
          f"anyres: {len(dpages)} pages at layouts {[g for g, _ in groups]} "
          f"({[dembs[i].shape[0] for _, idxs in groups for i in idxs]} tokens, "
          f"{sum(tiles) + len(tiles)} sub-images) in batches of {GRID['anyres_batch']}: "
          f"{len(dpages) / dyn_s:.2f} pages/s, peak {dyn_peak:.1f} GiB | K2 against its plain "
          f"version on the tower's first q, k, v at each shape: {k2_errs} | {card}", flush=True)
    del retr, dyn, client, rec
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches_all, "attention.granite_tower": sum(square_k2.values())}


def grid_colsmol(torch, seed: int, card: str, work: str) -> dict:
    """Phase 13 (b): ColSmol-256M at full width with image splitting (random
    bf16 weights): letter-size PDFs through ``PipelinedEmbedder`` and through
    ``create_document_embeddings`` (``embed_images`` a PDF), within 2e-2 of
    each other; every tower GEMM on ``gemm_wgmma`` (K5a), K1 in the scores;
    K5a against its plain version on every layer's input of the path; the
    tower quantized takes K2 and no K5a. -> launches."""
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch import api
    from multimodal_colpali_tpu_torch.ingest.pdfwrite import make_sample_pdf
    from multimodal_colpali_tpu_torch.ingest.pipeline import PipelinedEmbedder
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.ops import fused_layer as FL
    from multimodal_colpali_tpu_torch.ops.quant import quantize_encoder_params

    pdfs = Path(tempfile.mkdtemp(dir=work))
    for i in range(GRID["smol_pdfs"]):
        make_sample_pdf(str(pdfs / f"p{i}.pdf"), n_pages=GRID["smol_pages"], lines_per_page=40,
                        seed=seed + i)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        retr = load_retriever(COLSMOL, device="cuda", dtype=torch.bfloat16, seed=seed,
                              dynamic_resolution=True)
    cfg = retr.model.cfg
    b = GRID["smol_batch"]
    wrappers = kernel_wrappers()
    PipelinedEmbedder(retr, batch_size=b).embed_pdf_dir(str(pdfs))      # warm-up
    torch.cuda.synchronize()
    layer_inputs = {}           # batch -> each layer's input of its first forward

    def recorded(orig):
        def run(x, *params, **kw):
            seen = layer_inputs.setdefault(x.shape[0], [])
            if len(seen) < cfg.vision.num_hidden_layers:
                seen.append((x.clone(), params, kw))
            return orig(x, *params, **kw)
        return run

    reset_counts(wrappers)
    with Patched(FL, "fused_vit_layer", recorded):
        t0 = time.perf_counter()
        piped = PipelinedEmbedder(retr, batch_size=b).embed_pdf_dir(str(pdfs))
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seq = api.create_document_embeddings(str(pdfs), retr, batch_size=b)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    n = GRID["smol_pdfs"] * GRID["smol_pages"]
    require(len(piped) == len(seq) == n, f"{len(piped)} / {len(seq)} records, not {n}")
    err = 0.0
    for a, c in zip(piped, seq):
        require((a["doc_id"], a["page_id"], a["file_name"]) == (c["doc_id"], c["page_id"],
                                                               c["file_name"]),
                "PipelinedEmbedder and create_document_embeddings disagree on the records")
        require(a["embedding"].shape == c["embedding"].shape, "embedding shapes differ")
        err = max(err, float(np.abs(a["embedding"] - c["embedding"]).max()))
    require(err <= 2e-2, f"PipelinedEmbedder vs embed_images: max|diff| {err} > 2e-2")
    embs = [r["embedding"] for r in piped]
    unit_rows(np, embs)
    qs = retr.embed_queries(QUERIES)
    scores = retr.processor.score_multi_vector(qs, embs, device="cuda")
    require(scores.shape == (len(QUERIES), n) and bool(np.isfinite(scores).all()),
            "ColSmol scores")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image
    from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument

    page = resize_image(PdfDocument(str(pdfs / "p0.pdf")).render(0, dpi=144.0))
    tiles = retr.processor.tiling_for(page)
    subs = tiles[0] * tiles[1] + 1
    # one tiling for every page: the pipeline's batches, then each PDF's
    forwards = -(-n // b) + GRID["smol_pdfs"] * -(-GRID["smol_pages"] // b)
    layers = cfg.vision.num_hidden_layers
    require(launches["vit_layer"] == layers * forwards
            and launches["gemm"] == launches["gemm.wgmma"] == 4 * launches["vit_layer"]
            and launches["gemm.cuda_core"] == 0,
            f"ColSmol's split tower: {launches['vit_layer']} K5a launches (want "
            f"{layers * forwards}), GEMMs {launches['gemm']} ({launches['gemm.wgmma']} wgmma)")
    # score_multi_vector pads float32 embeddings: K1's CUDA-core path, as in JAX's order
    require(launches["maxsim"] > 0, "ColSmol: no K1")
    n_img = int((retr.processor.process_images([page], grid=tiles)["input_ids"]
                 == cfg.image_token_id).sum())
    require(n_img == subs * cfg.n_image_tokens, f"{n_img} image tokens a page")
    # K5a against its plain version on every layer's input, at each batch of
    # sub-images the path gave it (the pipeline's 8 pages, each PDF's 4). The
    # tower's activations reach ~34, not phase 2's N(0, 1), and the kernel and
    # the plain bf16 layer round apart by a bf16 ulp of the row's largest
    # terms (0.25 at 16-32), so phase 2's elementwise allclose fails on a
    # small output beside them. Held instead: (1) |kernel - plain| within
    # 3e-2 of the row's largest plain value; (2) the kernel within 1.25x the
    # plain bf16 layer's own error against the plain layer in float32; (3) the
    # first half of the batch, alone, equal bit for bit to the full batch's
    # first half (a fault of the batch size alone shows here)
    k5_err = {}
    for bsz, seen in sorted(layer_inputs.items()):
        for li, (x, params, kw) in enumerate(seen):
            where = f"K5a at [{bsz}, {x.shape[1]}, {x.shape[2]}], layer {li}"
            got = FL.fused_vit_layer_cuda(x, *params, **kw).float()
            want = FL.fused_vit_layer_reference(x, *params, **kw).float()
            want32 = FL.fused_vit_layer_reference(x.float(), *(t.float() for t in params), **kw)
            e5 = float((got - want).abs().max())
            e_row = float(((got - want).abs()
                           / want.abs().amax(-1, keepdim=True).clamp_min(1e-6)).max())
            e_k, e_p = (float((t - want32).abs().max()) for t in (got, want))
            half = FL.fused_vit_layer_cuda(x[: bsz // 2].contiguous(), *params, **kw).float()
            require(e_row <= 3e-2, f"{where}: max|err| {e5}, {e_row:.4f} of its row's "
                                   f"largest value, beyond 3e-2")
            require(e_k <= 1.25 * e_p, f"{where}: {e_k:.4f} from the float32 layer, beyond "
                                       f"1.25x the bf16 plain layer's {e_p:.4f}")
            require(torch.equal(half, got[: bsz // 2]),
                    f"{where}: the batch's first half alone differs from the full batch's")
            k5_err[bsz] = [max(a, b) for a, b in zip(k5_err.get(bsz, [0.0] * 4),
                                                     (e5, e_row, e_k, e_p))]
            del got, want, want32, half
    layer_inputs.clear()
    # the K5 gate: the same tower with int8 (W8A8) projections takes K2 and
    # never K5a; its embedding within the W8A8 cosine of bf16's
    ref = retr.embed_images([page])[0]
    quantize_encoder_params(retr.model)
    reset_counts(wrappers)
    q8 = retr.embed_images([page])[0]
    torch.cuda.synchronize()
    q8_launches = read_counts(wrappers)
    cos8 = float(np.mean(np.sum(q8 * ref, axis=-1)))
    require(q8_launches["vit_layer"] == q8_launches["gemm"] == 0
            and q8_launches["attention.tensor_core"] == layers,
            f"ColSmol's int8 tower: K5a {q8_launches['vit_layer']}, GEMMs {q8_launches['gemm']}, "
            f"K2 {q8_launches['attention.tensor_core']} (want 0, 0, {layers})")
    require(cos8 >= GRID["cos"], f"ColSmol W8A8: mean per-token cosine {cos8:.4f} < {GRID['cos']}")
    print(f"[grid] (b) {COLSMOL} with image splitting: {n} letter pages ({page.shape[1]} x "
          f"{page.shape[0]} px rasters, tiling {tiles}: {subs} sub-images, {n_img} image tokens, "
          f"{embs[0].shape[0]} tokens a page): PipelinedEmbedder {n / pipe_s:.2f} pages/s, "
          f"create_document_embeddings {n / seq_s:.2f} pages/s, max|diff| {err:.3g} (2e-2); "
          f"K5a {launches['vit_layer']} launches, {launches['gemm.wgmma']} wgmma GEMMs; K5a against "
          f"its plain version on every layer's input, a batch of sub-images: [max|err|, of "
          f"the row's largest, kernel / bf16 plain from float32] "
          f"{ {k: [float(f'{e:.3g}') for e in v] for k, v in k5_err.items()} }, "
          f"half batches bit-equal | "
          f"int8 tower: no K5a, K2 {q8_launches['attention.tensor_core']} launches, mean cosine "
          f"with bf16 {cos8:.4f} | {card}", flush=True)
    del retr
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def grid_w8a8(torch, seed: int, card: str, checkpoint: dict) -> dict:
    """Phase 13 (c): W8A8. ``vidore/colpali-v1.3`` from phase 3's checkpoint
    with ``quantize="int8"`` against the same checkpoint in bf16 on phase
    3's pages and queries, both timed alike: mean per-token cosine >= 0.98,
    each query's top-1 page bf16's up to near-ties of the measured scores;
    K2 and K1 launched, no K5 GEMM and no K8a.
    ``w8a8_dense`` at ColPali's Gemma MLP: its int32 sums equal an exact
    product on the host. Gemma-3's SigLIP tower (896 px) int8 against bf16
    over 5 images: mean cosine of the soft tokens >= 0.98. -> launches."""
    import types

    import numpy as np
    from multimodal_colpali_tpu_torch._timing import eager_ms
    from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine
    from multimodal_colpali_tpu_torch.models import load_retriever
    from multimodal_colpali_tpu_torch.models.configs import Gemma3MMConfig
    from multimodal_colpali_tpu_torch.models.registry import _vision_parts
    from multimodal_colpali_tpu_torch.ops import quant as Q

    pages = synthetic_pages(N_PAGES, 448, seed)               # phase 3's pages
    bf = load_retriever(COLPALI, device="cuda", dtype=torch.bfloat16,
                        checkpoint_dir=checkpoint["path"])
    # bf16 timed as the int8 run below is: the same warm-up, pages and syncs
    bf.embed_images(pages[:EMBED_BATCH], batch_size=EMBED_BATCH)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_pages = bf.embed_images(pages, batch_size=EMBED_BATCH)
    torch.cuda.synchronize()
    bf_embed_s = time.perf_counter() - t0
    ref_q = bf.embed_queries(QUERIES)
    ref_scores = bf.processor.score_multi_vector(ref_q, ref_pages, device="cuda")
    del bf
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    q8 = load_retriever(COLPALI, device="cuda", dtype=torch.bfloat16,
                        checkpoint_dir=checkpoint["path"], quantize="int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_int8 = sum(p.numel() for p in q8.model.parameters() if p.dtype == torch.int8)
    wrappers = kernel_wrappers()
    q8.embed_images(pages[:EMBED_BATCH], batch_size=EMBED_BATCH)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    embs = q8.embed_images(pages, batch_size=EMBED_BATCH)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    qs = q8.embed_queries(QUERIES)
    scores = q8.processor.score_multi_vector(qs, embs, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    unit_rows(np, embs)
    cos_p = float(np.mean([np.mean(np.sum(a * r, axis=-1)) for a, r in zip(embs, ref_pages)]))
    cos_q = float(np.mean([np.mean(np.sum(a * r, axis=-1)) for a, r in zip(qs, ref_q)]))
    require(cos_p >= GRID["cos"] and cos_q >= GRID["cos"],
            f"W8A8 ColPali: mean per-token cosine with bf16 {cos_p:.4f} (pages), {cos_q:.4f} "
            f"(queries) < {GRID['cos']}")
    # a near-tie, from the measured scores: d is the largest |int8 - bf16|
    # score of the other queries' pairs (not of the pair it judges); a
    # query's top-1 may differ from bf16's only where their bf16 scores are
    # within 2 d
    dev_scores = np.abs(np.asarray(scores) - np.asarray(ref_scores))
    d = float(dev_scores.max())
    ties = 0
    for qi in range(len(QUERIES)):
        a, r = int(np.argmax(scores[qi])), int(np.argmax(ref_scores[qi]))
        if a != r:
            sa, sr = ref_scores[qi, a], ref_scores[qi, r]
            tie = 2 * float(np.delete(dev_scores, qi, axis=0).max())
            require(abs(sa - sr) <= tie, f"query {qi}: W8A8 top-1 page {a}, bf16's {r}: bf16 "
                                         f"scores {sa:.4f} / {sr:.4f} beyond a near-tie "
                                         f"({tie:.4f}, twice the other queries' largest "
                                         f"score change)")
            ties += 1
    margin = float(np.min([np.diff(np.sort(ref_scores[qi]))[-1] for qi in range(len(QUERIES))]))
    require(launches["attention"] == launches["attention.tensor_core"] > 0
            and launches["maxsim"] > 0,
            f"W8A8 ColPali: K2 off its tensor cores or no K1: {launches}")
    # So400m is outside K5's plan in any dtype: phase 13 (b) shows the int8
    # gate on ColSmol's tower, which K5a takes in bf16
    require(launches["gemm"] == launches["vit_layer"] == launches["int8_matmul_kn"]
            == launches["int8_matmul_nk"] == 0,
            f"W8A8 ColPali reached a K5 GEMM or K8: {launches}")
    del q8
    gc.collect()
    torch.cuda.empty_cache()

    # w8a8_dense at ColPali's Gemma MLP: [8 x 1,030, 2,048] -> 16,384
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    m, k, n = GRID["mlp"]
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g, device=dev) * k ** -0.5).to(torch.bfloat16)
    qw = Q.quantize_int8(w, axis=1)
    xq, _ = Q.quantize_act_int8(x)
    acc = Q.int8_mm(xq, qw["q8"])
    # float64 sums of these integers stay below 2^53: exact in any order
    want = xq.cpu().double() @ qw["q8"].cpu().double().T
    require(torch.equal(acc.cpu().double(), want), "int8_mm's int32 sums differ from the "
                                                   "exact product on the host")
    del want
    w8_ms = eager_ms(lambda: Q.w8a8_dense(x, qw["q8"], qw["scale"]), iters=10)
    mm_ms = eager_ms(lambda: Q.int8_mm(xq, qw["q8"]), iters=10)
    bf_ms = eager_ms(lambda: torch.mm(x, w.T), iters=10)
    ops = 2.0 * m * k * n
    del x, w, qw, xq, acc
    torch.cuda.empty_cache()

    # Gemma-3's SigLIP-So400m at 896 px as _vision_parts builds it, alone
    gcfg = Gemma3MMConfig.gemma3_27b()
    tower, projector = _vision_parts(gcfg, dev, torch.bfloat16, seed=seed)
    lm = types.SimpleNamespace(dtype=torch.bfloat16, device=dev)     # the tower needs no LM
    pg = torch.Generator().manual_seed(seed + 14)
    side = gcfg.vision.image_size
    pix = torch.rand(1, GRID["g3_images"], side, side, 3, generator=pg).mul_(2).sub_(1).to(dev)
    before = read_counts(wrappers)["attention.tensor_core"]
    with torch.inference_mode():
        soft_bf = Gemma3MMEngine(gcfg, tower, projector, lm=lm)._image_features(pix).float()
        mm8 = Gemma3MMEngine(gcfg, tower, projector, lm=lm, vision_dtype="int8")
        soft_q = mm8._image_features(pix).float()
    torch.cuda.synchronize()
    g3_k2 = read_counts(wrappers)["attention.tensor_core"] - before
    cos_g3 = float(torch.nn.functional.cosine_similarity(soft_q, soft_bf, dim=-1).mean())
    require(soft_q.shape == (1, GRID["g3_images"] * gcfg.mm_tokens_per_image,
                             gcfg.text.hidden_size), f"soft tokens {tuple(soft_q.shape)}")
    require(cos_g3 >= GRID["cos"], f"Gemma-3 W8A8 tower: mean cosine {cos_g3:.4f} < "
                                   f"{GRID['cos']}")
    require(g3_k2 == 2 * gcfg.vision.num_hidden_layers,
            f"Gemma-3 towers launched K2 {g3_k2} times on its tensor cores")
    launches = read_counts(wrappers)
    print(f"[grid] (c) W8A8 {COLPALI} from phase 3's checkpoint (load + quantize {load_s:.1f} s, "
          f"{n_int8 / 1e9:.3f}B int8 weights): {N_PAGES} pages {N_PAGES / embed_s:.2f} pages/s "
          f"against the same checkpoint in bf16 {N_PAGES / bf_embed_s:.2f} pages/s (int8 "
          f"{embed_s / bf_embed_s:.2f}x the time), "
          f"peak {peak:.1f} GiB; mean per-token cosine with bf16 {cos_p:.4f} (pages), "
          f"{cos_q:.4f} (queries); top-1 equal to bf16's for {len(QUERIES) - ties} of "
          f"{len(QUERIES)} queries ({ties} near-ties; largest |int8 - bf16| score {d:.4f}, "
          f"smallest bf16 top-1 margin {margin:.4f}) | w8a8_dense [{m}, {k}] -> {n}: int32 sums "
          f"exact, {w8_ms:.3f} ms ({mm_ms:.3f} ms of it torch._int_mm, "
          f"{ops / mm_ms / 1e9:.0f} TOP/s), one bf16 torch.mm {bf_ms:.3f} ms | Gemma-3 tower "
          f"at {side} px, {GRID['g3_images']} images: int8 soft tokens' mean cosine with bf16 "
          f"{cos_g3:.4f} | {card}", flush=True)
    del tower, projector, mm8
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "w8a8_ms": w8_ms, "int_mm_ms": mm_ms, "bf16_mm_ms": bf_ms}


def phase_grid(torch, seed: int, card: str, work: str, checkpoint: dict) -> dict:
    """Phase 13: ColGranite (a), ColSmol's image splitting (b) and W8A8 (c) at
    full width, each a main path with its own counts. -> their launches and
    K2's at ColGranite's tower shape."""
    t_phase = time.perf_counter()
    a = grid_granite(torch, seed, card)
    b = grid_colsmol(torch, seed, card, work)
    c = grid_w8a8(torch, seed, card, checkpoint)
    for tag, part in (("a", a), ("b", b), ("c", c)):
        print(f"[grid] ({tag}) launches {json.dumps(part['launches'])}", flush=True)
    print(f"[grid] phase 13 {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    return {"paths": [a["launches"], b["launches"], c["launches"]],
            "attention.granite_tower": a["attention.granite_tower"]}


# -- phase 14: the old-model tier -----------------------------------------------------------

QWEN2VL = "AdaptLLM/biomed-Qwen2-VL-2B-Instruct"
LLAVA = "AdaptLLM/biomed-LLaVA-NeXT-Llama3-8B"
OLD = dict(slots=4, max_seq_len=6144, chunk=8, page=16, max_tokens=32, spec_k=4,
           text_tokens=(600, 1500), images=5)
OLD_SIZE = {"qwen": 756, "llava": 336,     # page pixels: each tower's own input size
            "mllama": 896}                 # (Mllama's: between its 1x1 and 2x2 canvases)


def rag_text(rng, n_tokens: int) -> str:
    """``n_tokens`` byte tokens of retrieved context whose passages repeat (a
    chunk retrieved twice, as RAG contexts hold), then an MCQ."""
    half = mcq_prompt(rng, n_tokens // 2 + 150)
    ctx = half[: half.index("\nQuestion:")]
    require(n_tokens - 1 - len(half) <= len(ctx), f"a RAG prompt of {n_tokens} tokens "
            f"repeats more than its context")
    text = ctx[: n_tokens - 1 - len(half)] + "\n" + half
    require(len(text.encode()) == n_tokens, f"a RAG prompt of {len(text.encode())} bytes, "
            f"not {n_tokens}")
    return text


def png_url(page) -> str:
    """An RGB page as a PNG data URL (the port's encoder, no Pillow)."""
    import base64

    from multimodal_colpali_tpu_torch.ingest.imageops import encode_png

    return "data:image/png;base64," + base64.b64encode(encode_png(page)).decode()


def old_model_requests(seed: int, size: int):
    """Phase 14's requests, sent at once: two RAG text requests, a 1-image and
    a 5-image request of pages at ``size`` px, each for ``OLD["max_tokens"]``
    tokens, and an MCQ ``response_format`` request. -> [(key, body)]."""
    import numpy as np

    rng = np.random.default_rng(seed + 60)
    pages = synthetic_pages(OLD["images"], size, seed + 61)
    out = [(f"text {n}", {"messages": [{"role": "user", "content": rag_text(rng, n)}],
                          "max_tokens": OLD["max_tokens"]}) for n in OLD["text_tokens"]]
    for n in (1, OLD["images"]):
        content = [{"type": "image_url", "image_url": {"url": png_url(p)}} for p in pages[:n]]
        out.append((f"{n} image{'s' if n > 1 else ''}", {
            "messages": [{"role": "user", "content": content + [
                {"type": "text", "text": QUESTION}]}], "max_tokens": OLD["max_tokens"]}))
    out.append(("mcq", {"messages": [{"role": "user", "content": mcq_prompt(rng, 600)}],
                        "max_tokens": 8, "response_format": MCQ_FORMAT}))
    return out


def old_model_run(torch, mm, pre, tok, tag: str, kv_dtype: str, spec_k: int, requests,
                  card: str, refs: dict, k2=None, k7=None, cross_max_images: int = 1,
                  tower_k2: bool = True, patches=()) -> dict:
    """One run of phase 14 or 15: the paged batcher (speculative when
    ``spec_k``; cross pools of ``cross_max_images`` for Mllama) and the HTTP
    server over ``mm`` and its LM, every request sent at once. Each greedy
    reply is held against the isolated engine's (``refs``: key -> (stream,
    top-2 gaps), filled on first use), and K7 (and, with ``tower_k2``, the
    tower's K2) ran on their tensor cores. ``k2`` / ``k7`` record the tower's
    attention and the step's paged attention (the verify's, or the plain
    decode's), ``patches`` more (owner, name, recorder). -> launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_colpali_tpu_torch.generation import (
        GenerationServer, PagedContinuousBatcher, SpeculativePagedContinuousBatcher,
        extract_chat_content)
    from multimodal_colpali_tpu_torch.generation import paged as P
    from multimodal_colpali_tpu_torch.generation import speculative as S
    from multimodal_colpali_tpu_torch.models import layers as L

    wrappers = kernel_wrappers()
    eng = mm.lm
    kw = dict(batch_slots=OLD["slots"], max_seq_len=OLD["max_seq_len"], chunk=OLD["chunk"],
              page_size=OLD["page"], kv_dtype=kv_dtype, eos_id=tok.eos_id, mm_engine=mm)
    if getattr(mm, "cross_decode", False):
        kw.update(cross_max_images=cross_max_images, prefill_cache_entries=4)
    bat = (SpeculativePagedContinuousBatcher(eng, spec_k=spec_k, **kw) if spec_k
           else PagedContinuousBatcher(eng, **kw)).serve()
    srv = GenerationServer(bat, tok, model_name=tag, host="127.0.0.1", port=0, mm_engine=mm,
                           image_preprocessor=pre).start()
    ttft = {}
    admit = bat._finish_admission

    def noted(slot, req, *a, **k):
        fresh = not req.tokens
        admit(slot, req, *a, **k)
        if fresh:
            ttft[len(req.prompt)] = time.monotonic() - req.t_submit

    bat._finish_admission = noted
    verify_fn = "paged_attention_int8" if kv_dtype == "int8" else "paged_attention"
    try:
        warm = synthetic_pages(1, OLD_SIZE[tag.split("-")[0]], 7)[0]
        for body in ({"messages": [{"role": "user", "content": "warm"}], "max_tokens": 2},
                     {"messages": [{"role": "user", "content": [
                         {"type": "image_url", "image_url": {"url": png_url(warm)}},
                         {"type": "text", "text": "warm"}]}], "max_tokens": 2}):
            require(chat(srv.base_url, body)[0] == 200, f"[{tag}] warm-up request failed")
        torch.cuda.synchronize()
        bat.decode_s, bat.decode_steps, bat.decode_tokens = 0.0, 0, 0
        bat.spec_forwards = bat.spec_accepted = 0
        ttft.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        with contextlib.ExitStack() as stack:
            for owner, name, wrap in ((L, "fused_attention", k2), (S if spec_k else P,
                                                                   verify_fn, k7), *patches):
                stack.enter_context(Patched(owner, name, wrap or (lambda f: f)))
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(requests)) as ex:
                outs = list(ex.map(lambda r: chat(srv.base_url, r[1]), requests))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = read_counts(wrappers)
        require((not tower_k2 or launches["attention"] == launches["attention.tensor_core"] > 0)
                and launches["paged_attention"] + launches["paged_attention_int8"]
                == launches["paged_attention.tensor_core"]
                + launches["paged_attention_int8.tensor_core"] > 0,
                f"[{tag}] K2 or K7 off its tensor cores: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        accepted = bat.spec_accepted / max(bat.spec_forwards, 1) if spec_k else 1.0
        decode = (bat.decode_tokens, bat.decode_s, bat.decode_steps)
    finally:
        srv.stop()
        bat.shutdown()
    del bat
    gc.collect()
    torch.cuda.empty_cache()

    notes, ttft_ms = [], {}
    eng.record_top2 = True
    for (key, body), (status, text, finish, secs) in zip(requests, outs):
        require(status == 200 and text, f"[{tag}] {key} request failed: {status} {text!r}")
        if key == "mcq":
            require(json.loads(text).get("answer") in ("A", "B", "C", "D"),
                    f"[{tag}] the MCQ reply is not a choice: {text!r}")
            ttft_ms[key] = round(secs * 1e3, 1)
            continue
        got = [int(t) for t in text.split()]
        require(finish == "length", f"[{tag}] {key}: finish {finish}")
        ids, pix = srv._prepare_ids(*extract_chat_content(body["messages"]))
        ttft_ms[key] = round(ttft.get(len(ids), float("nan")) * 1e3, 1)
        if key not in refs:
            want = (eng.generate([ids], max_new_tokens=OLD["max_tokens"], eos_id=tok.eos_id)
                    if pix is None else mm.generate([ids], pix[None],
                                                    max_new_tokens=OLD["max_tokens"],
                                                    eos_id=tok.eos_id))[0]
            refs[key] = (want, eng.top2_gaps[0])
        want, gaps = refs[key]
        notes.append(check_greedy(tag, key, got, want, lambda i, g=gaps: float(g[i])))
    eng.record_top2 = False
    tokens, secs, steps = decode
    print(f"[{tag}] {eng.weight_dtype} weights, {kv_dtype} KV, "
          f"{f'speculative k={spec_k}' if spec_k else 'no speculation'}: {len(requests)} "
          f"requests at once in {wall:.2f} s | accepted tokens a verify {accepted:.3f} | TTFT "
          f"ms {ttft_ms} | decode {tokens / max(secs, 1e-9):.1f} tokens/s over "
          f"{OLD['slots']} slots, {1e3 * secs / max(steps, 1):.1f} ms a step | peak "
          f"{peak:.1f} GiB | greedy vs the isolated engines: {'; '.join(notes)} | {card}",
          flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    return launches


def path_attention_row(torch, inputs, label: str) -> dict:
    """K2 against its plain version on the q, k, v a tower gave it at its
    5-image shape (``tower_k2_against_plain``), on its tensor cores, a repeat
    bit-identical; timed beside the plain version and SDPA."""
    from multimodal_colpali_tpu_torch._timing import eager_ms
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch.ops import attention as A

    (q, k, v, kv_lens, kv_valid), kw = inputs
    require(kv_lens is None and kv_valid is None, f"K2 at {label}: the tower passed a mask")
    b, s, h, d = q.shape
    tc = A.fused_attention_cuda.tensor_core_launches
    err = tower_k2_against_plain(torch, {tuple(q.shape): inputs})[str(list(q.shape))]
    require(A.fused_attention_cuda.tensor_core_launches == tc + 1,
            f"K2 at {label}: off its tensor-core path")
    require(torch.equal(A.fused_attention_cuda(q, k, v, **kw),
                        A.fused_attention_cuda(q, k, v, **kw)),
            f"K2 at {label}: a repeated call differs")

    def plain():
        return torch.cat([A.attention_reference(q[i: i + 1], k[i: i + 1], v[i: i + 1], **kw)
                          for i in range(b)])

    k_ms, p_ms = timed_pair(torch, lambda: A.fused_attention_cuda(q, k, v, **kw), plain,
                            iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=kw["scale"]),
                      iters=12)
    r = row(err, k_ms, p_ms, 4 * q.numel() * 2, 4.0 * b * h * s * s * d, library_ms=lib_ms)
    print(f"[kernels] K2 attention at {label} {list(q.shape)} on the path's own q, k, v "
          f"(tensor cores): max|err| {err:.3g}, repeat bit-identical | kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.3f} ms (one image at a time), scaled_dot_product_attention "
          f"{lib_ms:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)
    return r


def path_verify_row(torch, inputs, int8: bool, label: str, k: int = OLD["spec_k"]) -> dict:
    """K7a / K7b against its plain version on the q, pools, repeated block
    table and per-row lengths a speculative verify gave it (``k`` rows a
    slot; 1: a plain decode step), with phase 2's limits (floor 2e-2 / 0.035,
    2^-7 |want| + 2e-3 / 4e-3), a repeat bit-identical; timed beside the
    plain version (no single PyTorch call reads paged pools)."""
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    args, kw = inputs
    q, bt, lens = args[0], args[-2], args[-1]
    fn = PA.paged_attention_int8_cuda if int8 else PA.paged_attention_cuda
    ref = PA.paged_attention_int8_reference if int8 else PA.paged_attention_reference
    floor, atol = (0.035, 4e-3) if int8 else (2e-2, 2e-3)
    tc = fn.tensor_core_launches
    got = fn(*args, **kw).float()
    require(fn.tensor_core_launches == tc + 1, f"K7 at {label}: off its tensor-core path")
    want = ref(*args, **kw).float()
    diff = (got - want).abs()
    err = float(diff.max())
    excess = float((diff - 2.0 ** -7 * want.abs()).max())
    require(err <= floor and excess <= atol,
            f"K7 at {label} {list(q.shape)}: max|err| {err} (floor {floor}), max(|err| - "
            f"2^-7|want|) {excess} > {atol}")
    require(torch.equal(fn(*args, **kw).float(), got), f"K7 at {label}: two calls differ")
    k_ms, p_ms = timed_pair(torch, lambda: fn(*args, **kw), lambda: ref(*args, **kw), iters=20)
    hkv, d = args[1].shape[-2], q.shape[-1]
    require(torch.equal(bt[::k].repeat_interleave(k, dim=0), bt),
            f"K7 at {label}: the block table is not each slot's repeated {k} times")
    # the k rows of a slot read the same pages: the function needs each slot's
    # K/V once, up to its longest row; each query row does its own products
    kv_rows = int(lens.view(-1, k).max(dim=1).values.sum())
    per_row = (d + 4) if int8 else 2 * d
    nbytes = 2 * kv_rows * hkv * per_row + 2 * q.numel() * 2 + bt.numel() * 4
    r = row(err, k_ms, p_ms, nbytes, 4.0 * q.shape[1] * d * int(lens.sum()))
    print(f"[kernels] {'K7b' if int8 else 'K7a'} at {label}: q {list(q.shape)}, block table "
          f"{list(bt.shape)} (each slot's repeated), lengths {lens.tolist()}: max|err| "
          f"{err:.3g}, max(|err| - 2^-7|want|) {excess:.3g}, repeat bit-identical | kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
          flush=True)
    return r


def phase_old_models(torch, seed: int, card: str) -> dict:
    """Phase 14, the old-model tier, random weights made on the card from
    ``seed``, behind ``GenerationServer`` on 4 slots of 6,144, pages of 16.
    (a) Qwen2-VL-2B at full width and depth on the speculative paged
    batcher (k = 4): bf16 weights and KV (K2 in the tower, K7a over the verify
    rows), int8 weights with int8 KV (K8a, K8b on the tied head, K7b), int4
    weights (K9, K8b). (b) LLaVA-NeXT-Llama3-8B at full width: bf16 through
    the plain paged batcher, then speculative with int8 KV (K7b), then (b2)
    int8 weights made leaf by leaf (K8a on every projection and the untied
    head), speculative. Every greedy reply equals the isolated engine's up to
    near-ties. Then K2 and K7 against their plain versions on the path's own
    tensors. -> {"paths": launch counts a run, kernels-line rows, "launches"
    of the rows}."""
    import warnings

    from multimodal_colpali_tpu_torch.generation import (
        LlamaDecodeEngine, LlavaNextImagePreprocessor, LlavaNextMMEngine, ModuloTokenizer,
        Qwen2DecodeEngine, Qwen2VLImagePreprocessor, Qwen2VLMMEngine)
    from multimodal_colpali_tpu_torch.models import registry as R

    t_phase = time.perf_counter()
    paths, out = [], {}
    k = OLD["spec_k"]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # random weights: the init warns
        cfg, params, _ = R.load_qwen2vl_mm(QWEN2VL, device="cuda", dtype=torch.bfloat16,
                                           seed=seed)
    torch.cuda.synchronize()
    n_params = sum(int(t.numel()) for _, t in R.tree_leaves(
        {"embed": params["embed"], "language_model": params["language_model"]})) + sum(
        p.numel() for p in params["visual"].parameters())
    print(f"[old-qwen] {QWEN2VL}: {n_params / 1e9:.3f}B params bf16, random init on the card "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tok = ModuloTokenizer(cfg.text.vocab_size)
    pre = Qwen2VLImagePreprocessor(cfg, device="cuda")
    requests = old_model_requests(seed, OLD_SIZE["qwen"])
    tower_shape = (OLD["images"], cfg.grid_h * cfg.grid_w, cfg.vision.num_heads,
                   cfg.vision.head_dim)
    verify_shape = (OLD["slots"] * k, cfg.text.num_attention_heads, cfg.text.head_dim)
    k2, k7, k7b = CallRecorder(), CallRecorder(), CallRecorder()
    for wd, kv, rec in (("native", "native", k7), ("int8", "int8", k7b), ("int4", "native", None)):
        lm = Qwen2DecodeEngine(cfg.text, params, dtype=torch.bfloat16, weight_dtype=wd,
                               device="cuda")
        mm = Qwen2VLMMEngine(cfg, params["visual"], lm)
        launches = old_model_run(torch, mm, pre, tok, f"qwen-{wd}", kv, k, requests, card, {},
                                 k2=k2 if wd == "native" else None, k7=rec)
        paths.append(launches)
        if wd != "native":
            require(launches["int8_matmul_nk"] > 0 and launches[
                "int8_matmul_kn" if wd == "int8" else "int4_matmul_kn"] > 0,
                f"[qwen-{wd}] the quantized weights did not run K8a / K9 and K8b: {launches}")
        del lm, mm
        gc.collect()
        torch.cuda.empty_cache()
    require(k2.shapes.get(tower_shape) == cfg.vision.depth,
            f"Qwen2-VL's tower launched K2 at {k2.shapes}, not {cfg.vision.depth} times at "
            f"{tower_shape}")
    require(k7.shapes.get(verify_shape, 0) > 0 and k7b.shapes.get(verify_shape, 0) > 0,
            f"the verify did not run K7a / K7b at {verify_shape}: {k7.shapes} {k7b.shapes}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["attention.qwen2vl_tower"] = path_attention_row(torch, k2.inputs[tower_shape],
                                                        "Qwen2-VL's tower")
    out["paged_attention.verify"] = path_verify_row(torch, k7.inputs[verify_shape], False,
                                                    "Qwen2-VL-2B's verify (group 6)")
    launches = {"attention.qwen2vl_tower": k2.shapes[tower_shape],
                "paged_attention.verify": k7.shapes[verify_shape],
                "paged_attention_int8.verify": k7b.shapes[verify_shape]}
    del k2, k7, k7b
    gc.collect()
    torch.cuda.empty_cache()

    requests = old_model_requests(seed, OLD_SIZE["llava"])
    k2, k7b = CallRecorder(), CallRecorder()
    for wd in ("native", "int8"):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg, params, _ = R.load_llava_next_mm(LLAVA, device="cuda", dtype=torch.bfloat16,
                                                  seed=seed, weight_dtype=wd)
        torch.cuda.synchronize()
        print(f"[old-llava] {LLAVA}: {wd} LM weights, random init on the card "
              f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} "
              f"GiB", flush=True)
        tok = ModuloTokenizer(cfg.text.vocab_size)
        lm = LlamaDecodeEngine(cfg.text, params, dtype=torch.bfloat16, device="cuda")
        mm = LlavaNextMMEngine(cfg, params["vision_tower"], params["multi_modal_projector"], lm)
        pre = LlavaNextImagePreprocessor(cfg, device="cuda")
        refs: dict = {}
        runs = ([("native", 0, k2, None), ("int8", k, None, k7b)] if wd == "native"
                else [("native", k, None, None)])
        for kv, spec, rec2, rec7 in runs:
            run = old_model_run(torch, mm, pre, tok, f"llava-{wd}", kv, spec, requests, card,
                                refs, k2=rec2, k7=rec7)
            paths.append(run)
            require(wd == "native" or run["int8_matmul_kn"] > 0, f"[llava-int8] no K8a: {run}")
        del lm, mm, params, refs
        gc.collect()
        torch.cuda.empty_cache()
    clip_shape = (OLD["images"], cfg.vision.num_positions, cfg.vision.num_attention_heads,
                  cfg.vision.hidden_size // cfg.vision.num_attention_heads)
    verify_shape = (OLD["slots"] * k, cfg.text.num_attention_heads, cfg.text.head_dim)
    require(k2.shapes.get(clip_shape) == cfg.feature_layers,
            f"CLIP launched K2 at {k2.shapes}, not {cfg.feature_layers} times at {clip_shape}")
    require(k7b.shapes.get(verify_shape, 0) > 0,
            f"LLaVA's verify did not run K7b at {verify_shape}: {k7b.shapes}")
    out["attention.clip_tower"] = path_attention_row(torch, k2.inputs[clip_shape],
                                                     "CLIP-L/336's tower")
    out["paged_attention_int8.verify"] = path_verify_row(
        torch, k7b.inputs[verify_shape], True, "Llama-3-8B's verify over int8 pools (group 4)")
    launches["attention.clip_tower"] = k2.shapes[clip_shape]
    launches["paged_attention_int8.verify"] += k7b.shapes[verify_shape]
    del k2, k7b
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[old] phase 14 took {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    return {"paths": paths, "rows": out, "launches": launches}


MLLAMA = "llama-3.2-11b-vision"
MLLAMA_RUN = dict(cross_max_images=5, live_gap=1e-3, cosine=0.98)


def mllama_requests(seed: int):
    """Phase 15's requests: phase 14's two RAG text requests, a 1-image and a
    5-image request, and the MCQ over the same 5 images (constrained)."""
    out = old_model_requests(seed, OLD_SIZE["mllama"])
    images = [p for p in out[3][1]["messages"][0]["content"] if p["type"] == "image_url"]
    mcq = out[4][1]
    text = mcq["messages"][0]["content"]
    mcq["messages"][0]["content"] = images + [{"type": "text", "text": text}]
    return out


def path_int8_row(torch, inputs, label: str) -> dict:
    """K8a against its plain version on the x, codes and scales a path gave
    it (phase 2's limit: 2% of the largest plain value), on the tile its rows
    select, a repeat bit-identical; timed beside the plain version and
    ``_weight_int8pack_mm``."""
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM

    (x, w, sc), kw = inputs
    m, k = x.shape
    n = w.shape[1]
    tile = "decode" if m <= 16 else "prefill"
    fn = IM.int8_matmul_kn_cuda
    before = getattr(fn, f"{tile}_launches")
    got = fn(x, w, sc, **kw).float()
    require(getattr(fn, f"{tile}_launches") == before + 1, f"K8a at {label}: not its {tile} tile")
    want = IM.int8_matmul_reference(x, w, sc).float()
    err = float((got - want).abs().max())
    limit = 0.02 * float(want.abs().max())
    require(bool(torch.isfinite(got).all()) and err <= limit,
            f"K8a at {label} [{m}, {k}] x {list(w.shape)}: max|err| {err} > 2% of max {limit}")
    require(torch.equal(fn(x, w, sc, **kw), fn(x, w, sc, **kw)), f"K8a at {label}: two calls "
            f"differ")
    call = lambda: fn(x, w, sc, **kw)  # noqa: E731
    e_ms, p_ms = timed_pair(torch, call, lambda: IM.int8_matmul_reference(x, w, sc), iters=5)
    k_ms = graph_ms(call, iters=10)
    int8pack = library_op(torch, "_weight_int8pack_mm")
    lib_ms = None
    if int8pack:
        w_nk, s_x = w.t().contiguous(), sc.to(x.dtype)
        lib_ms = eager_ms(lambda: int8pack(x, w_nk, s_x), iters=3)
        del w_nk
    r = row(err, k_ms, p_ms, w.numel() + sc.numel() * 4 + x.numel() * 2 + m * n * 2,
            2.0 * m * k * n, library_ms=lib_ms)
    print(f"[kernels] K8a at {label}: x [{m}, {k}] bf16 x codes {list(w.shape)} ({tile} tile): "
          f"max|err| {err:.3g} (limit 2% of max, {limit:.3g}), repeat bit-identical | kernel "
          f"{k_ms:.4f} ms (CUDA graph; eager {e_ms:.4f}), plain {p_ms:.3f} ms, "
          f"_weight_int8pack_mm {'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return r


def mllama_prefill_split(torch, mm, ids, pix):
    """One image prompt's prefill split by CUDA events into the tower, the
    projector, the cross K/V of every cross layer and the LM (every layer with
    the cross blocks, and the head); the second of two runs. -> ms each."""
    from multimodal_colpali_tpu_torch.generation.engine import left_pad

    eng = mm.lm
    s = -(-len(ids) // 16) * 16
    tid, mask = (eng._tensor(a) for a in left_pad([ids], s, 0))
    pix = mm._pixels(pix)[None]
    with torch.inference_mode():
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            kc, vc = eng._caches(1, s)
            ev[0].record()
            feats = mm._tower(pix)
            ev[1].record()
            states = mm._project(feats, 1)
            ev[2].record()
            ckv = mm._cross_kv(states)
            ev[3].record()
            amask, full_row = mm._cross_masks(tid, mask, pix.shape[1])
            positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
            hidden, _ = eng._chunk(eng.params, eng._embed(eng.params, tid), positions, kc, vc,
                                   0, mask.bool(), interleave=mm._interleave(ckv, amask,
                                                                             full_row))
            eng._logits(eng.params, hidden[:, -1])
            ev[4].record()
            torch.cuda.synchronize()
            del kc, vc, feats, states, ckv, hidden
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def phase_mllama(torch, seed: int, card: str) -> dict:
    """Phase 15, Llama-3.2-11B-Vision (Mllama) at full width and depth on
    random weights made on the card from ``seed``, behind ``GenerationServer``
    on 4 slots of 6,144, pages of 16, cross pools of 5 images a slot. (a) bf16
    weights and KV, tiles 1x1, the plain paged batcher (K7a); (b) the
    speculative paged batcher (k = 4) over int8 KV (K7b over the B * k verify
    rows, the cross blocks in the verify); (c) int8 weights made leaf by leaf,
    tiles 2x2, the W8A8 tower (K8a on every self and cross projection and the
    untied head, both tiles). Every greedy reply equals the isolated engine's
    up to near-ties, the MCQ over 5 images answers a choice, another image
    changes the 1-image request's first logits, the W8A8 tower keeps a cosine
    of 0.98 with bf16's. Then K7a, K7b and K8a against their plain versions on
    the path's own tensors. -> {"paths", "rows", "launches"}."""
    import warnings

    from multimodal_colpali_tpu_torch.generation import (
        LlamaDecodeEngine, MllamaImagePreprocessor, MllamaMMEngine, ModuloTokenizer,
        extract_chat_content)
    from multimodal_colpali_tpu_torch.generation.server import GenerationServer
    from multimodal_colpali_tpu_torch.models import registry as R
    from multimodal_colpali_tpu_torch.ops import quant as Q

    t_phase = time.perf_counter()
    k, n_img = OLD["spec_k"], MLLAMA_RUN["cross_max_images"]
    requests = mllama_requests(seed)
    paths, out = [], {}
    k7, k7b, k8 = CallRecorder(), CallRecorder(), CallRecorder()

    def load(wd: str):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # random weights: the init warns
            cfg, params, _ = R.load_mllama_mm(MLLAMA, device="cuda", dtype=torch.bfloat16,
                                              seed=seed, weight_dtype=wd)
        torch.cuda.synchronize()
        n = sum(int(t.numel()) for _, t in R.tree_leaves(
            {key: params[key] for key in ("embed", "language_model", "cross_layers")})) + sum(
            p.numel() for p in params["vision_tower"].parameters())
        print(f"[mllama] {MLLAMA}: {n / 1e9:.3f}B params, {wd} LM and cross layers, random init "
              f"on the card {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        return cfg, params

    def engines(cfg, params, tiles, vision_dtype="native"):
        lm = LlamaDecodeEngine(cfg.text, params, dtype=torch.bfloat16, device="cuda")
        mm = MllamaMMEngine(cfg, params["vision_tower"], params["multi_modal_projector"],
                            params["cross_layers"], lm, vision_dtype=vision_dtype, tiles=tiles)
        return mm, MllamaImagePreprocessor(cfg, tiles=tiles, device="cuda")

    cfg, params = load("native")
    tok = ModuloTokenizer(cfg.text.vocab_size)
    mm, pre = engines(cfg, params, (1, 1))
    refs: dict = {}
    common = dict(cross_max_images=n_img, tower_k2=False)
    paths.append(old_model_run(torch, mm, pre, tok, "mllama-a", "native", 0, requests, card,
                               refs, k7=k7, **common))
    # the cross path is live: another image moves the 1-image request's logits
    srv = GenerationServer(mm.lm, tok, mm_engine=mm, image_preprocessor=pre)
    msgs = requests[2][1]["messages"]
    prompt, pages = extract_chat_content(msgs)
    ids, pix = srv._prepare_ids(prompt, pages)
    other = pre(synthetic_pages(1, OLD_SIZE["mllama"], seed + 90))
    a, b = (torch.from_numpy(mm.next_token_logits([ids], p[None])) for p in (pix, other))
    gap = float((a - b).abs().max())
    require(gap > MLLAMA_RUN["live_gap"], f"[mllama] another image left the 1-image request's "
            f"first logits within {gap} (the cross path is not live)")
    ids5, pix5 = srv._prepare_ids(*extract_chat_content(requests[3][1]["messages"]))
    torch.cuda.reset_peak_memory_stats()
    split = mllama_prefill_split(torch, mm, ids5, pix5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[mllama] the image changes the first logits by up to {gap:.4f} | 5-image prefill "
          f"({len(ids5)} tokens, {pix5.shape[0]} x {cfg.vision.max_num_tiles} tiles): tower "
          f"{split[0]:.1f} ms, projector {split[1]:.1f} ms, cross K/V {split[2]:.1f} ms, LM "
          f"{split[3]:.1f} ms (CUDA events) | peak {peak:.1f} GiB | {card}", flush=True)
    del srv
    paths.append(old_model_run(torch, mm, pre, tok, "mllama-b", "int8", k, requests, card,
                               refs, k7=k7b, **common))
    del mm, pre, params, refs
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = load("int8")
    mm, pre = engines(cfg, params, (2, 2))
    page = mm._pixels(pre(synthetic_pages(1, OLD_SIZE["mllama"], seed + 91)))
    with torch.inference_mode():
        ref = mm._tower(page[None]).float()
        mm, pre = engines(cfg, params, (2, 2), vision_dtype="int8")   # the tower W8A8, in place
        got = mm._tower(page[None]).float()
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).mean())
    require(mm.vision_tower.local_0.fc1.weight.dtype == torch.int8 and
            cos >= MLLAMA_RUN["cosine"], f"[mllama] the W8A8 tower's cosine with bf16's is {cos}")
    print(f"[mllama] W8A8 tower against bf16 on one 2x2 page: mean per-token cosine {cos:.5f}",
          flush=True)
    del ref, got
    run = old_model_run(torch, mm, pre, tok, "mllama-c", "native", 0, requests, card, {},
                        patches=[(Q, "int8_matmul_kn", k8)], **common)
    paths.append(run)
    require(run["int8_matmul_kn.decode"] > 0 and run["int8_matmul_kn.prefill"] > 0,
            f"[mllama-c] K8a did not run both tiles: {run}")
    del mm, pre, params
    gc.collect()
    torch.cuda.empty_cache()

    c = cfg.text
    decode_shape = (OLD["slots"], c.num_attention_heads, c.head_dim)
    verify_shape = (OLD["slots"] * k, c.num_attention_heads, c.head_dim)
    kv_rows = n_img * cfg.vision.max_num_tiles * cfg.vision.num_patches
    kv_shape = (kv_rows, c.hidden_size)
    require(k7.shapes.get(decode_shape, 0) > 0 and k7b.shapes.get(verify_shape, 0) > 0
            and k8.shapes.get(kv_shape, 0) > 0,
            f"[mllama] K7a at {decode_shape}, K7b at {verify_shape} or K8a at {kv_shape} did not "
            f"run: {k7.shapes} {k7b.shapes} {sorted(k8.shapes)}")
    out["paged_attention.mllama_decode"] = path_verify_row(
        torch, k7.inputs[decode_shape], False, "Llama-3.2-11B-Vision's decode step", k=1)
    out["paged_attention_int8.mllama_verify"] = path_verify_row(
        torch, k7b.inputs[verify_shape], True, "Llama-3.2-11B-Vision's verify over int8 pools")
    out["int8_matmul_kn.mllama_cross_kv"] = path_int8_row(
        torch, k8.inputs[kv_shape], f"the cross K/V rows of {n_img} images at 2x2")
    launches = {"paged_attention.mllama_decode": k7.shapes[decode_shape],
                "paged_attention_int8.mllama_verify": k7b.shapes[verify_shape],
                "int8_matmul_kn.mllama_cross_kv": k8.shapes[kv_shape]}
    del k7, k7b, k8
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mllama] phase 15 took {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    return {"paths": paths, "rows": out, "launches": launches}


# phase 12: the experiment drivers against the port's server; the question
# tables are synthetic, in driver 05's wording
# phase 16: training. ColPali v1.3 at full width and depth in float32, 3 pages
# of 448 px and 3 queries (2 peaked at 54.8 GiB, so a third page fits the 80 GB),
# 5 AdamW steps on the fixed batch; then 2 SigLIP + 2 Gemma layers at full width
# for the checks against the plain versions and the checkpoint round trip. lr
# 1e-5: at optax's default 1e-4, Adam's first steps (every weight moved by about
# lr) swing the random 2.9B model's loss (3 pages: 1.06 -> 1.84 -> 1.08)
TRAIN = dict(pages=3, queries=3, steps=5, lr=1e-5, depth=(2, 2), loss_rel=1e-5, grad_rel=1e-4,
             grad_floor=1e-6, remat_rel=1e-6, bwd_rel=1e-4)
K2_TRAIN = dict(b=TRAIN["pages"], s=1024, h=16, d=72)   # the tower's attention over the pages


class Float32Numerics:
    """float32 products and convolutions in full float32 (no TF32) and
    cuDNN's deterministic algorithms (the patch embedding's weight gradient;
    a resumed step must repeat bit for bit), restored on exit."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
        b.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic = self.saved


def train_batch(torch, cfg, seed: int):
    """``TRAIN``'s queries (the processor's prompt, 32 tokens with its
    padding) and synthetic 448-px pages (1,024 image tokens and the prompt),
    normalized as the processor does, on the card."""
    from multimodal_colpali_tpu_torch.models.processing import ColPaliProcessor

    proc = ColPaliProcessor(cfg)
    pages = synthetic_pages(TRAIN["pages"], cfg.vision.image_size, seed + 16)
    docs = proc.process_images(pages, device="cuda")
    qs = proc.process_queries(QUERIES[: TRAIN["queries"]])
    dev = torch.device("cuda")
    as_long = lambda a: torch.as_tensor(a, device=dev).long()  # noqa: E731
    return {"query_ids": as_long(qs["input_ids"]), "query_mask": as_long(qs["attention_mask"]),
            "doc_ids": as_long(docs["input_ids"]), "doc_mask": as_long(docs["attention_mask"]),
            "doc_pixels": torch.as_tensor(docs["pixel_values"], device=dev).float()}


def train_flops(cfg, batch) -> float:
    """Model FLOPs of one training step, counted analytically: 6 per
    parameter a token meets (the tower's per patch, the projector's per
    image token, Gemma's and the head's per token; the embedding table is a
    lookup) plus 3 x the attention's 4 S^2 (heads x head_dim) a layer."""
    v, t = cfg.vision, cfg.text
    h, hv = t.hidden_size, v.hidden_size
    siglip = v.num_hidden_layers * (4 * hv * hv + 2 * hv * v.intermediate_size) \
        + 3 * v.patch_size ** 2 * hv
    gemma = t.num_hidden_layers * (h * t.num_attention_heads * t.head_dim * 2
                                   + 2 * h * t.num_key_value_heads * t.head_dim
                                   + 3 * h * t.intermediate_size)
    flops = 0.0
    for ids, pix in ((batch["query_ids"], False), (batch["doc_ids"], True)):
        b, s = ids.shape
        flops += 6.0 * b * s * (gemma + h * cfg.embedding_dim)
        flops += 3 * 4.0 * b * s * s * t.num_attention_heads * t.head_dim * t.num_hidden_layers
        if pix:
            p = v.num_patches
            flops += 6.0 * b * p * (siglip + hv * v.projection_dim)
            flops += 3 * 4.0 * b * p * p * hv * v.num_hidden_layers
    return flops


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def grads_close(got: dict, want: dict, rel: float, floor: float) -> tuple:
    """Each leaf within ``rel`` of its largest element plus ``floor`` of the
    largest gradient of the model (leaves whose true gradient is 0, the
    k-projection biases, hold rounding noise on both sides) -> (worst ratio
    of error to bound, its leaf)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = (0.0, "")
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        ratio = err / (rel * float(w.abs().max()) + floor * top)
        worst = max(worst, (ratio, n))
    return worst


def k2_training_rows(torch, g, heads: int = K2_TRAIN["h"], tag: str = "") -> dict:
    """K2's float32 forward and its backward, both on the tensor cores in
    3xTF32, at the training path's ``[3, 1024, 16, 72]`` against their plain
    versions (1e-4: the forward's atol, the backward's share of each
    gradient's largest element), unmasked and at a masked case (kv_lens,
    kv_valid, causal, batch 0's row 0 seeing no key), repeats bit-identical;
    the unmasked errors of kernel and plain version against float64 (the
    forward's largest absolute error, each gradient's over its largest
    element); times by CUDA events beside the bound of the kernels' design
    (``bound_ms``: three TF32 products at 495 TFLOP/s for each float32 one)
    and the float32 one at 67 TFLOP/s (``bound_f32_ms``), the registers and
    spills ptxas reported for the launched instantiations; SDPA's forward
    and its backward (one ``autograd.grad`` of its float32 output) on the
    same tensors as yardsticks, timed only. ``heads`` < 16 gives a rank's
    shape under tensor parallelism, and ``tag`` ends the rows' names. -> the
    two kernel rows, each with ``check_launches``: its checks' launches (the
    timing's left out)."""
    import torch.nn.functional as F
    from multimodal_colpali_tpu_torch import _build
    from multimodal_colpali_tpu_torch._timing import eager_ms
    from multimodal_colpali_tpu_torch.ops import attention as A

    c = dict(K2_TRAIN, h=heads)
    dev = torch.device("cuda")
    shape = (c["b"], c["s"], c["h"], c["d"])
    q, k, v, do = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
    scale = c["d"] ** -0.5
    n = q.numel()
    pairs = c["b"] * c["h"] * c["s"] ** 2 * c["d"]
    n8 = (c["d"] + 7) // 8
    valid = torch.rand(c["b"], c["s"], generator=g, device=dev) > 0.1
    valid[0, 0] = False        # causal: batch 0's row 0 sees no key
    lens = torch.full((c["b"],), 700, dtype=torch.int32, device=dev)
    lens[0] = c["s"]
    masked = dict(kv_lens=lens, kv_valid=valid, causal=True)

    def fwd_check(kw, label):
        before = A.fused_attention_cuda.tf32_launches
        got = A.fused_attention_cuda(q, k, v, scale=scale, **kw)
        require(A.fused_attention_cuda.tf32_launches == before + 1,
                f"K2 in float32 ({label}) did not take its 3xTF32 tensor-core path")
        err = float((got - A.attention_reference(q, k, v, scale=scale, **kw)).abs().max())
        require(math.isfinite(err) and err <= 1e-4,
                f"K2 float32 {label} at {list(shape)}: max|err| {err} > 1e-4")
        require(torch.equal(A.fused_attention_cuda(q, k, v, scale=scale, **kw), got),
                f"K2 float32 {label}: a repeated call differs")
        return got, err

    checks = {"fwd": A.fused_attention_cuda.launches,
              "bwd": A.fused_attention_backward_cuda.launches}
    out, f_err = fwd_check({}, "at the path's shape")
    _, fm_err = fwd_check(masked, "masked")
    checks["fwd"] = A.fused_attention_cuda.launches - checks["fwd"]
    f_ms, f_plain = timed_pair(torch, lambda: A.fused_attention_cuda(q, k, v, scale=scale),
                               lambda: A.attention_reference(q, k, v, scale=scale), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    f_lib = eager_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=5)
    fwd = row(max(f_err, fm_err), f_ms, f_plain, 4 * n * 4, 4.0 * pairs, peak=TF32_FLOPS / 3,
              library_ms=f_lib)
    print(f"[train] K2 float32 forward (3xTF32) against attention_reference: max|err| "
          f"{f_err:.3g} at {list(shape)}, {fm_err:.3g} with kv_lens, kv_valid, causal and a "
          f"fully masked row (atol 1e-4), repeats bit-identical", flush=True)

    def bwd_check(kw, label):
        o = A.attention_reference(q, k, v, scale=scale, **kw)
        got = A.fused_attention_backward_cuda(q, k, v, o, do, scale=scale, **kw)
        ref = A.attention_backward_reference(q, k, v, o, do, scale=scale, **kw)
        errs = []
        for name, a, w in zip(("dq", "dk", "dv"), got, ref):
            err = float((a - w).abs().max())
            bound_ = TRAIN["bwd_rel"] * float(w.abs().max())
            require(torch.isfinite(a).all() and err <= bound_,
                    f"K2 backward {label}: {name} max|err| {err} > {bound_:.3g}")
            errs.append(err)
        again = A.fused_attention_backward_cuda(q, k, v, o, do, scale=scale, **kw)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K2 backward {label}: a repeated call differs")
        return got, max(errs)

    _, b_err = bwd_check({}, "at the path's shape")
    (dq, dk, dv), m_err = bwd_check(masked, "masked")
    checks["bwd"] = A.fused_attention_backward_cuda.launches - checks["bwd"]
    require(not dq[0, 0].any(), "K2 backward: the fully masked row has a dq")
    print(f"[train] K2 backward (3xTF32) against attention_backward_reference: max|err| "
          f"{b_err:.3g} at {list(shape)}, {m_err:.3g} with kv_lens, kv_valid, causal and a "
          f"fully masked row (each within {TRAIN['bwd_rel']} of the largest element), repeats "
          f"bit-identical", flush=True)

    b_ms, b_plain = timed_pair(
        torch, lambda: A.fused_attention_backward_cuda(q, k, v, out, do, scale=scale),
        lambda: A.attention_backward_reference(q, k, v, out, do, scale=scale), iters=5)
    xs = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*xs, scale=scale)
    lib_do = do.transpose(1, 2)
    b_lib = eager_ms(lambda: torch.autograd.grad(lib_out, xs, lib_do, retain_graph=True),
                     iters=5)
    bwd = row(max(b_err, m_err), b_ms, b_plain, 8 * n * 4, 10.0 * pairs, peak=TF32_FLOPS / 3,
              library_ms=b_lib)
    fwd["bound_f32_ms"] = 4.0 * pairs / F32_FLOPS * 1e3
    bwd["bound_f32_ms"] = 10.0 * pairs / F32_FLOPS * 1e3
    fwd["check_launches"], bwd["check_launches"] = checks["fwd"], checks["bwd"]

    # against float64, unmasked: the kernel's error beside the plain version's
    q64, k64, v64, o64, do64 = (x.double() for x in (q, k, v, out, do))
    want = A.attention_reference(q64, k64, v64, scale=scale)
    fwd["err_f64"] = float((out.double() - want).abs().max())
    fwd["plain_err_f64"] = float(
        (A.attention_reference(q, k, v, scale=scale).double() - want).abs().max())
    got = A.fused_attention_backward_cuda(q, k, v, out, do, scale=scale)
    plain = A.attention_backward_reference(q, k, v, out, do, scale=scale)
    ref = A.attention_backward_reference(q64, k64, v64, o64, do64, scale=scale)
    bwd["rel_err_f64"], bwd["plain_rel_err_f64"] = (
        {name: float((a.double() - r).abs().max() / r.abs().max())
         for name, a, r in zip(("dq", "dk", "dv"), grads, ref)} for grads in (got, plain))
    del q64, k64, v64, o64, do64, want, got, plain, ref
    fwd["ptxas"] = {"attention_tf32": _build.ptxas_registers("attention",
                                                             f"attention_tf32ILi{n8}EE")}
    bwd["ptxas"] = {kern: _build.ptxas_registers("attention_backward", f"{kern}ILi{n8}EE")
                    for kern in ("bwd_dq_tf32", "bwd_dkdv_tf32")}
    spilled = {kern: rs for r in (fwd, bwd) for kern, rs in r["ptxas"].items() if rs[1]}
    require(not spilled, f"K2's float32 kernels at D = {c['d']} spill (registers, bytes): "
                         f"{spilled}")
    for label, r, lib in (("forward", fwd, "scaled_dot_product_attention"),
                          ("backward", bwd, "SDPA's backward")):
        regs = ", ".join(f"{kern}<{n8}> {rg} registers, {sp} bytes spilled"
                         for kern, (rg, sp) in r["ptxas"].items())
        print(f"[train] K2 {label} float32 (3xTF32) at {list(shape)}: kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, {lib} {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}: 3 TF32 products at 495 TFLOP/s), "
              f"float32 bound {r['bound_f32_ms']:.3f} ms (67 TFLOP/s) | ptxas: {regs}",
              flush=True)
    print(f"[train] against float64: forward max|err| {fwd['err_f64']:.3g} (plain "
          f"{fwd['plain_err_f64']:.3g}); backward over each gradient's largest element "
          + ", ".join(f"{n} {bwd['rel_err_f64'][n]:.3g} (plain {bwd['plain_rel_err_f64'][n]:.3g})"
                      for n in ("dq", "dk", "dv")), flush=True)
    del q, k, v, do, out, xs, lib_out, dq, dk, dv
    torch.cuda.empty_cache()
    return {f"attention.training{tag}": fwd, f"attention_backward{tag}": bwd}


def phase_training(torch, seed: int, card: str, work: str) -> dict:
    """Phase 16, training ColPali (``training/``) on the card, float32 (the
    JAX trainer's dtype). (a) ``vidore/colpali-v1.3`` at full width and depth
    (2.925B), random from ``seed``: 5 AdamW steps (lr 1e-5, optax's defaults)
    of ``make_train_step`` on a fixed batch of 3 queries and 3 pages; every
    loss and gradient finite, the last loss below the first, K2's forward and
    backward kernels launched 27 times a step (the page forward's tower).
    (b) 2 SigLIP + 2 Gemma layers at full width: one step against the same
    step under ``set_fused_attention(False)`` (the plain attention and its
    autograd, on the card): loss rel 1e-5, every gradient within 1e-4 of its
    leaf's largest element plus 1e-6 of the largest; ``remat=True`` against
    it: loss rel 1e-6; a checkpoint saved after step 2 and restored into a
    fresh model and optimizer: step 3 equals the uninterrupted step 3 bit for
    bit. (c) K2's rows at the path's shape (``k2_training_rows``).
    -> {"path", "rows", "launches"}."""
    import statistics

    from multimodal_colpali_tpu_torch.models import layers as L
    from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
    from multimodal_colpali_tpu_torch.models.registry import (RETRIEVER_CONFIGS,
                                                              init_random_params_)
    from multimodal_colpali_tpu_torch.training import make_train_step, make_training_setup
    from multimodal_colpali_tpu_torch.training.checkpoint import (
        make_checkpoint_manager, restore_train_state, save_train_state)

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()
    cfg = RETRIEVER_CONFIGS[COLPALI]()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    with Float32Numerics(torch):
        # (a) full width and depth
        batch = train_batch(torch, cfg, seed)
        t0 = time.perf_counter()
        model = ColPaliModel(cfg, device="cuda", dtype=torch.float32)
        init_random_params_(model, seed)
        opt = make_training_setup(model, learning_rate=TRAIN["lr"])
        step = make_train_step(model, opt)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        setup_s = time.perf_counter() - t0
        layers = cfg.vision.num_hidden_layers
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        losses, walls = [], []
        for i in range(TRAIN["steps"]):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            finite = torch.stack([torch.isfinite(p.grad).all() for p in model.parameters()])
            require(bool(finite.all()), f"train step {i + 1}: a gradient is not finite")
            require(math.isfinite(losses[-1]), f"train step {i + 1}: loss {losses[-1]}")
        path = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = TRAIN["steps"]
        require(path["attention"] == path["attention.tf32"] == steps * layers,
                f"train: K2 forward launches {path['attention']} (3xTF32 "
                f"{path['attention.tf32']}), not {steps * layers}")
        require(path["attention_backward"] == steps * layers,
                f"train: K2 backward launches {path['attention_backward']}, not "
                f"{steps * layers}")
        require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
        others = {k: n for k, n in path.items()
                  if n and not k.startswith("attention")}
        require(not others, f"train: unexpected kernels on the training path: {others}")
        step_s = statistics.median(walls[1:])
        tokens = sum(batch[k].numel() for k in ("query_ids", "doc_ids"))
        flops = train_flops(cfg, batch)
        print(f"[train] (a) {COLPALI} float32, {n_params / 1e9:.3f}B parameters, built and "
              f"initialized in {setup_s:.1f} s; {steps} AdamW steps (lr {TRAIN['lr']}) on "
              f"{TRAIN['queries']} queries x {batch['query_ids'].shape[1]} tokens + "
              f"{TRAIN['pages']} pages x {batch['doc_ids'].shape[1]} tokens: losses "
              f"{[round(x, 6) for x in losses]} | step {step_s:.3f} s (median of steps 2-"
              f"{steps}; first {walls[0]:.3f} s) = {tokens / step_s:.0f} tokens/s, "
              f"{flops / step_s / 1e12:.1f} model TFLOP/s ({flops / 1e12:.2f} TFLOP a step) | "
              f"peak {peak:.2f} GiB | K2 {path['attention']} forward + "
              f"{path['attention_backward']} backward launches | {card}", flush=True)
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()

        # (b) reduced depth, full width
        sv, st = TRAIN["depth"]
        small = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=sv),
            text=dataclasses.replace(cfg.text, num_hidden_layers=st))
        model = ColPaliModel(small, device="cuda", dtype=torch.float32)
        init_random_params_(model, seed)
        start = {n: t.clone() for n, t in model.state_dict().items()}

        def fresh(remat=False):
            model.load_state_dict(start)
            o = make_training_setup(model, learning_rate=TRAIN["lr"])
            return o, make_train_step(model, o, remat=remat)

        def counted_step(stp):
            reset_counts(wrappers)
            loss = float(stp(batch))
            return loss, read_counts(wrappers)

        _, stp = fresh()
        l_k, c_k = counted_step(stp)
        g_k = grads_of(model)
        L.set_fused_attention(False)
        try:
            _, stp = fresh()
            l_p, c_p = counted_step(stp)
        finally:
            L.set_fused_attention(None)
        worst, leaf = grads_close(grads_of(model), g_k, TRAIN["grad_rel"], TRAIN["grad_floor"])
        del g_k
        require(c_k["attention"] == c_k["attention_backward"] == sv
                and c_p["attention"] == c_p["attention_backward"] == 0,
                f"train (b): K2 launches {c_k['attention']} / {c_k['attention_backward']} with "
                f"the kernels, {c_p['attention']} / {c_p['attention_backward']} plain")
        require(abs(l_k - l_p) <= TRAIN["loss_rel"] * abs(l_p),
                f"train (b): loss {l_k} with the kernels, {l_p} plain")
        require(worst <= 1.0, f"train (b): gradient of {leaf} off by {worst:.3g}x its bound")
        _, stp = fresh(remat=True)
        l_r, c_r = counted_step(stp)
        require(abs(l_r - l_k) <= TRAIN["remat_rel"] * abs(l_k)
                and c_r["attention"] == 2 * sv and c_r["attention_backward"] == sv,
                f"train (b): remat loss {l_r} against {l_k}; K2 {c_r['attention']} forward, "
                f"{c_r['attention_backward']} backward launches")

        opt, stp = fresh()
        stp(batch)
        stp(batch)
        mgr = make_checkpoint_manager(Path(work) / "train-ckpt", max_to_keep=2)
        t0 = time.perf_counter()
        save_train_state(mgr, 2, model, opt)
        save_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in mgr.step_dir(2).iterdir()) / 1e9
        l3 = float(stp(batch))
        want = {n: p.detach().clone() for n, p in model.named_parameters()}
        del opt, stp, model, start
        gc.collect()
        model = ColPaliModel(small, device="cuda", dtype=torch.float32)
        opt = make_training_setup(model, learning_rate=TRAIN["lr"])
        t0 = time.perf_counter()
        require(restore_train_state(mgr, model, opt) == 2, "train (b): restored the wrong step")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        r3 = float(make_train_step(model, opt)(batch))
        same = all(torch.equal(p.detach(), want[n]) for n, p in model.named_parameters())
        require(r3 == l3 and same, f"train (b): the resumed step 3 differs: loss {r3} against "
                f"{l3}, parameters {'equal' if same else 'differ'}")
        print(f"[train] (b) {sv} SigLIP + {st} Gemma layers at full width "
              f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B): loss {l_k:.7f} with "
              f"K2 and its backward, {l_p:.7f} plain (rel {abs(l_k - l_p) / abs(l_p):.2g}); "
              f"gradients within {worst:.3g} of their bound (worst {leaf}); remat {l_r:.7f} "
              f"(rel {abs(l_r - l_k) / abs(l_k):.2g}); checkpoint of step 2 {ckpt_gb:.2f} GB "
              f"saved in {save_s:.1f} s, restored in {load_s:.1f} s, step 3 resumed bit for "
              f"bit (loss {r3:.7f}) | {card}", flush=True)
        del model, opt, want
        shutil.rmtree(mgr.directory, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the kernels against their plain versions at the path's shape
        rows = k2_training_rows(torch, torch.Generator(device="cuda").manual_seed(seed + 16))
        for r in rows.values():      # the path's launches count here, not the checks'
            del r["check_launches"]
    print(f"[train] phase 16 {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    return {"path": path, "rows": rows,
            "launches": {"attention.training": path["attention"],
                         "attention_backward": path["attention_backward"]}}


EXPERIMENTS = dict(questions=12, run_questions=4, top_k=5, serve_timeout=600)
IMPORT_GUARD = """
import json, sys, time
REFUSED = ("jax", "PIL", "pandas", "aiohttp")
class Refuse:
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused in a card process: " + name)
sys.meta_path.insert(0, Refuse())
import chip_smoke as smoke
module, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
m = __import__(module, fromlist=["main"])
wrappers = smoke.kernel_wrappers()
smoke.reset_counts(wrappers)
if module.endswith(".serve"):
    # the server's launches since it started, at GET /stats
    from multimodal_colpali_tpu_torch.generation.server import GenerationServer
    stats = GenerationServer.stats
    GenerationServer.stats = lambda self: dict(stats(self), launches=smoke.read_counts(wrappers))
    m.main(argv)
    sys.exit(0)
spent = {}
def timed(owner, name, key):
    orig = getattr(owner, name)
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
    setattr(owner, name, run)
from multimodal_colpali_tpu_torch.generation import messages
from multimodal_colpali_tpu_torch import api
timed(messages, "_data_url", "encode_s")
timed(api, "score_results", "retrieve_s")
if hasattr(m, "load_or_embed"):
    timed(m, "load_or_embed", "embed_s")
    timed(m, "run_sync", "send_s")
t0 = time.perf_counter()
m.main(argv)
spent["wall_s"] = time.perf_counter() - t0
spent["launches"] = smoke.read_counts(wrappers)
spent["modules"] = sorted(n for n in sys.modules if n.split(".")[0] in REFUSED)
with open(out, "w") as f:
    json.dump(spent, f)
"""


def question_table(path: Path, n: int, papers, seed: int) -> None:
    """A question table in driver 05's wording (benchmark_placeholder.csv's
    columns), ``n`` synthetic questions about the corpus's papers."""
    import csv

    import numpy as np

    rng = np.random.default_rng(seed + 12)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["Question_nr", "Paper_id", "Nr_data_suppl", "doi", "title", "question",
                    "A", "B", "C", "D", "Correct", "Difficulty"])
        for i in range(n):
            paper = papers[i % len(papers)]
            words = " ".join(rng.choice(WORDS, size=int(rng.integers(6, 14))))
            w.writerow([i + 1, paper, 0, f"https://doi.org/10.0000/{paper}", f"{paper} title",
                        f"Which statement about {words}?",
                        *[" ".join(rng.choice(WORDS, size=int(rng.integers(2, 6))))
                          for _ in range(4)],
                        "ABCD"[int(rng.integers(4))], ("Easy", "Medium", "Hard")[i % 3]])


def server_stats(base: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        return json.loads(r.read())


def stats_delta(after: dict, before: dict) -> dict:
    per = {k: v - before["images_per_request"].get(k, 0)
           for k, v in after["images_per_request"].items()}
    return {"requests": after["requests"] - before["requests"],
            "images_decoded": after["images_decoded"] - before["images_decoded"],
            "images_skipped": after["images_skipped"] - before["images_skipped"],
            "images_per_request": {k: v for k, v in per.items() if v},
            "launches": {k: v - before["launches"][k] for k, v in after["launches"].items()}}


def phase_experiments(torch, seed: int, card: str, work: str, ckpt_root: Path) -> list:
    """Phase 12: experiments 01 and 02 as the reference runs them, through
    the port's server. ``serve`` runs as a subprocess on phase 3's ColPali
    checkpoint (``PaliGemmaEngine`` behind ``PagedContinuousBatcher``);
    against it, each driver as a subprocess; the server and the drivers run
    under ``IMPORT_GUARD``, which refuses jax, PIL, pandas and aiohttp and
    counts each process's kernel launches (the server's through ``/stats``,
    taken as deltas a driver): ``experiment01`` on phase 10's collections in
    modes no-RAG, mm_RAG and colpali, and in colpali again with a local
    model's name (no schema: the server decodes); ``experiment01_run`` over
    the four modes (``--repeats 1``, its own smaller table); ``experiment02
    --retrievers vidore/colqwen2.5-v0.2 vidore/colpali-v1.3 --context`` on
    phase 10's PDFs (phase 11's checkpoint). Every schema answer must be
    one of A-D, every colpali / --context request must reach the server with
    its 5 images decoded, every context reference must name a corpus page,
    the artifacts' schemas must hold, and each kernel of the path must run
    where it belongs. -> the launch counts of every process, for the
    kernels line."""
    import csv
    import os
    import pickle
    import socket
    import urllib.request

    t_phase = time.perf_counter()
    root = Path(work) / "ingest"
    papers_dir, storage = root / "papers", root / "vd" / "storage"
    pdfs = sorted(p.name for p in papers_dir.glob("*.pdf"))
    from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument

    n_pages = {Path(p).stem: len(PdfDocument(str(papers_dir / p))) for p in pdfs}
    out = Path(work) / "experiments"
    out.mkdir()
    qa, qa_small = out / "questions.csv", out / "questions_small.csv"
    question_table(qa, EXPERIMENTS["questions"], [Path(p).stem for p in pdfs], seed)
    question_table(qa_small, EXPERIMENTS["run_questions"], [Path(p).stem for p in pdfs], seed)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, COLPALI_TPU_CKPT_DIR=str(ckpt_root),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    log = open(out / "serve.log", "w")
    t0 = time.perf_counter()
    server = subprocess.Popen([sys.executable, "-c", IMPORT_GUARD, f"{PACKAGE}.serve", "-",
                               "--model", COLPALI, "--paged", "--max-seq-len", "8192",
                               "--port", str(port)],
                              env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(out))
    base = f"http://127.0.0.1:{port}"
    results = {}
    try:
        while True:
            require(server.poll() is None, f"serve exited with {server.returncode}: "
                    f"{(out / 'serve.log').read_text()[-3000:]}")
            try:
                urllib.request.urlopen(base + "/health", timeout=5).read()
                break
            except OSError:
                require(time.perf_counter() - t0 < EXPERIMENTS["serve_timeout"],
                        "serve did not come up")
                time.sleep(1.0)
        serve_up_s = time.perf_counter() - t0

        def drive(tag, module, argv, timeout=900):
            before = server_stats(base)
            spent = out / f"{tag}.json"
            t1 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", IMPORT_GUARD, f"{PACKAGE}.drivers.{module}",
                                str(spent), *argv], env=env, cwd=str(out), capture_output=True,
                               text=True, timeout=timeout)
            require(r.returncode == 0, f"{module} ({tag}) exited {r.returncode}:\n"
                    f"{(r.stdout + r.stderr)[-4000:]}")
            info = json.loads(spent.read_text())
            require(info["modules"] == [], f"{module} imported {info['modules']}")
            info["delta"] = stats_delta(server_stats(base), before)
            info["proc_s"] = time.perf_counter() - t1
            results[tag] = info
            return info

        common = ["--vllm_port", str(port), "--model_name", "gpt-5", "--base-url", base + "/v1",
                  "--seed", str(seed), "--storage-path", str(storage), "--retriever", COLPALI,
                  "--top_k", str(EXPERIMENTS["top_k"])]
        n_q = EXPERIMENTS["questions"]
        refs_ok = set()
        for mode, vdb in (("", ""), ("mm_RAG", "RAG_MM_gemma3"), ("colpali", "colpali")):
            tag = f"e01_{mode or 'no_RAG'}"
            info = drive(tag, "experiment01", [*common, "--qa_path", str(qa), "--type", mode,
                                               "--vector_db", vdb, "--filepath_output",
                                               str(out / tag / "eval")])
            (pkl,) = (out / tag).glob("eval_*.pkl")
            blob = pickle.loads(pkl.read_bytes())
            require(sorted(blob) == ["elapsed_time", "evaluation", "model", "permuted_answers",
                                     "timestamp"] and len(blob["evaluation"]) == n_q,
                    f"{tag}: pickle schema {sorted(blob)}")
            for rec in blob["evaluation"]:
                require(sorted(rec) == ["Question_nr", "answer", "context_refs", "filt_resp",
                                        "quest_order", "question", "resp_init"],
                        f"{tag}: record keys {sorted(rec)}")
                require(rec["answer"] in ("A", "B", "C", "D"), f"{tag}: answer {rec['answer']!r}")
                for ref in rec["context_refs"]:
                    stem, _, pg = ref.rpartition("_pg_")
                    require(stem.removesuffix(".pdf") in n_pages, f"{tag}: reference {ref!r}")
                    refs_ok.add(ref)
            d = info["delta"]
            require(d["requests"] == n_q and d["images_skipped"] == 0,
                    f"{tag}: the server saw {d}")
            if mode == "colpali":
                require(d["images_per_request"] == {str(EXPERIMENTS["top_k"]): n_q},
                        f"{tag}: images a request {d['images_per_request']}, not "
                        f"{EXPERIMENTS['top_k']} in each of {n_q}")
                require(all(len(r["context_refs"]) == EXPERIMENTS["top_k"]
                            for r in blob["evaluation"]), f"{tag}: context references")
                # K1 in the store's search; the server's SigLIP forwards on K2
                require(info["launches"]["maxsim"] > 0, f"{tag}: no K1 in the driver: "
                        f"{info['launches']}")
                require(d["launches"]["attention"] == d["launches"]["attention.tensor_core"] > 0,
                        f"{tag}: the server's image forwards did not run K2 on its tensor "
                        f"cores: {d['launches']}")
        # a local model's name: no schema, so the server decodes (K7a)
        n_local = EXPERIMENTS["run_questions"]
        local = drive("e01_local", "experiment01", [
            *[a if a != "gpt-5" else "paligemma-local" for a in common], "--qa_path",
            str(qa_small), "--type", "colpali", "--vector_db", "colpali", "--filepath_output",
            str(out / "e01_local" / "eval")])
        (pkl,) = (out / "e01_local").glob("eval_*.pkl")
        blob = pickle.loads(pkl.read_bytes())
        require(len(blob["evaluation"]) == n_local and all(
            r["answer"] in ("", "A", "B", "C", "D") and isinstance(r["resp_init"], str)
            for r in blob["evaluation"]), f"e01_local: records {blob['evaluation']}")
        d = local["delta"]
        require(d["requests"] == n_local and d["images_skipped"] == 0
                and d["images_per_request"] == {str(EXPERIMENTS["top_k"]): n_local},
                f"e01_local: the server saw {d}")
        require(d["launches"]["paged_attention"] == d["launches"]["paged_attention.tensor_core"]
                > 0 and d["launches"]["attention.tensor_core"] > 0,
                f"e01_local: the server's decode did not run K7a, or its image prefill K2, on "
                f"the tensor cores: {d['launches']}")
        run = drive("e01_run", "experiment01_run", [
            "--vllm_port", str(port), "--model_name", "gpt-5", "--model_name_short", "gpt5",
            "--vd_mm_name", "RAG_MM_gemma3", "--vd_colpali_name", "colpali",
            "--vd_text_name", "RAG_TEXT", "--repeats", "1", "--top_k", str(EXPERIMENTS["top_k"]),
            "--qa_path", str(qa_small), "--base-url", base + "/v1", "--storage-path",
            str(storage), "--retriever", COLPALI])
        legs = sorted((out / "results" / "eval").glob("*.pkl"))
        require(len(legs) == 8, f"experiment01_run wrote {len(legs)} pickles, not 8")
        for leg in legs:
            blob = pickle.loads(leg.read_bytes())
            require(all(r["answer"] in ("A", "B", "C", "D") for r in blob["evaluation"]),
                    f"{leg.name}: answers {[r['answer'] for r in blob['evaluation']]}")
        require(run["delta"]["requests"] == 8 * EXPERIMENTS["run_questions"]
                and run["delta"]["images_skipped"] == 0
                and run["delta"]["launches"]["attention.tensor_core"] > 0,
                f"experiment01_run: {run['delta']}")
        k = EXPERIMENTS["top_k"]
        e2 = drive("e02", "experiment02", [
            "--qa_path", str(qa), "--pdf_dir", str(papers_dir), "--results_dir",
            str(out / "evals"), "--cache_dir", str(out / "cache"), "--models", "gpt-5",
            "--retrievers", COLQWEN, COLPALI, "--iterations", "1", "--top_k", str(k),
            "--context", "--base-url", base + "/v1", "--seed", str(seed)])
        csvs = sorted((out / "evals").glob("eval_*.csv"), key=lambda p: p.stat().st_mtime_ns)
        require([p.name.split("_")[1] for p in csvs] == ["colqwen2.5", "colpali"],
                f"experiment02 wrote {[p.name for p in csvs]}")
        for p in csvs:
            with open(p, newline="") as f:
                rows = list(csv.DictReader(f))
            require(len(rows) == n_q and list(rows[0])[-5:] == [
                "Model", "Model_ret", "Answer", "Context_papers", "Cor_answer"],
                f"{p.name}: header {list(rows[0])}")
            for r in rows:
                require(r["Answer"] in ("A", "B", "C", "D") and r["Cor_answer"] in ("0", "1"),
                        f"{p.name}: answer {r['Answer']!r}")
                refs = eval(r["Context_papers"])        # noqa: S307 - the driver's own str(list)
                require(len(refs) == k, f"{p.name}: {len(refs)} context pages")
                for ref in refs:
                    stem, _, pg = ref.rpartition("_pg_")
                    require(stem in n_pages and 0 <= int(pg) < n_pages[stem],
                            f"{p.name}: reference {ref!r} names no corpus page")
        for name in (COLQWEN, COLPALI):
            cache = out / "cache" / f"{name.replace('/', '_')}_pdf_emb.pkl"
            entries = pickle.loads(cache.read_bytes())
            require(len(entries) == sum(n_pages.values()) and all(
                sorted(e) == ["doc_id", "embedding", "file_name", "page_id"]
                and e["embedding"].dtype.name == "float32" for e in entries),
                f"{cache.name}: schema")
        d = e2["delta"]
        require(d["requests"] == 2 * n_q and d["images_skipped"] == 0
                and d["images_per_request"] == {str(k): 2 * n_q},
                f"experiment02: the server saw {d}")
        # the two towers on K2's tensor cores, score_results' float32 MaxSim
        # on K1's CUDA cores; the server's image forwards on K2
        e2l = e2["launches"]
        require(e2l["attention"] == e2l["attention.tensor_core"] > 0
                and e2l["maxsim.cuda_core"] > 0,
                f"experiment02: the driver's launches {e2l}")
        require(d["launches"]["attention"] == d["launches"]["attention.tensor_core"] > 0,
                f"experiment02: the server's launches {d['launches']}")
    finally:
        server.terminate()
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        log.close()
    e01 = {t: results[t]["proc_s"] for t in ("e01_no_RAG", "e01_mm_RAG", "e01_colpali",
                                             "e01_local")}
    serve_s = e2["send_s"] - e2.get("encode_s", 0.0) - e2.get("retrieve_s", 0.0)
    print(f"[experiments] serve ({COLPALI}, PaliGemmaEngine, paged) up in {serve_up_s:.1f} s; "
          f"{n_q} questions (of the reference's 120; driver 05's wording, synthetic) | "
          f"experiment01 process s: " + ", ".join(f"{t} {s:.1f}" for t, s in e01.items())
          + f"; every colpali request {EXPERIMENTS['top_k']} images decoded, "
          f"{len(refs_ok)} distinct context pages | experiment01_run 8 legs of "
          f"{EXPERIMENTS['run_questions']} questions {run['proc_s']:.1f} s | experiment02 "
          f"({COLQWEN}, {COLPALI}; --context, top {k}) wall {e2['wall_s']:.1f} s: embed "
          f"{e2['embed_s']:.1f} (both retrievers, {sum(n_pages.values())} pages each), "
          f"retrieve {e2['retrieve_s']:.1f}, encode {e2['encode_s']:.1f} "
          f"({2 * n_q * k} JPEG data URLs), serve {serve_s:.1f}; "
          f"no driver or server imported jax, PIL, pandas or aiohttp; phase 12 "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    for tag, info in results.items():
        print(f"[experiments] {tag} launches: driver "
              f"{json.dumps({k: v for k, v in info['launches'].items() if v})}, server "
              f"{json.dumps({k: v for k, v in info['delta']['launches'].items() if v})}",
              flush=True)
    return [c for info in results.values() for c in (info["launches"],
                                                     info["delta"]["launches"])]


# phase 17: the scale-out at world size 1
SCALE = dict(pages=8192, nt=1056, dim=128, queries=4, nq=32, limit=5, depth=4, new_tokens=16,
             shard=2048, slots=4, max_seq_len=2048, chunk=8, page=16, repeats=7, embed_repeats=5,
             rate_tokens=128, rate_repeats=4)


def spread(xs) -> str:
    """``median [min-max]`` of a list of readings."""
    import statistics

    return f"{statistics.median(xs):.2f} [{min(xs):.2f}-{max(xs):.2f}]"


def interleaved(repeats: int, fns: dict) -> dict:
    """Each of the two callables ``fns`` (name -> fn returning a reading) run
    ``repeats`` times, alternating which goes first (ABBA...), so a drift of
    the host or the card reaches both alike -> name -> list of readings."""
    a, b = fns
    out = {a: [], b: []}
    for r in range(repeats):
        for who in ((a, b) if r % 2 == 0 else (b, a)):
            out[who].append(fns[who]())
    return out
SCALE_MODES = {"exact": {}, "int8": dict(quantized=True),
               "pooled": dict(quantized=True, prefilter="pooled")}


def scale_corpus(torch, g):
    """The phase's pages: unit bf16 tokens with ragged lengths (a quarter of
    ``nt`` to ``nt``, the rest zero), made on the card; and a float32 host copy."""
    import torch.nn.functional as F

    c, dev = SCALE, torch.device("cuda")
    d = torch.empty(c["pages"], c["nt"], c["dim"], dtype=torch.bfloat16, device=dev)
    lens = torch.randint(c["nt"] // 4, c["nt"] + 1, (c["pages"],), generator=g, device=dev,
                         dtype=torch.int32)
    cols = torch.arange(c["nt"], device=dev)
    for s in range(0, c["pages"], 512):
        part = F.normalize(torch.randn(min(512, c["pages"] - s), c["nt"], c["dim"], generator=g,
                                       device=dev), dim=-1)
        part *= (cols[None, :] < lens[s: s + 512, None])[..., None]
        d[s: s + 512] = part.to(torch.bfloat16)
    return d, lens, d.float().cpu().numpy(), lens.cpu().numpy()


def scale_store(torch, card: str, mesh, seed: int, g) -> dict:
    """(a): the sharded collections against the mesh-less ones, and the view."""
    import numpy as np
    from multimodal_colpali_tpu_torch.ops import two_stage as T2
    from multimodal_colpali_tpu_torch.store import (
        DistributedCorpusView, FieldCondition, Filter, MatchValue, MultiVectorConfig,
        PointStruct, VectorClient, VectorParams)

    c = SCALE
    t0 = time.perf_counter()
    d, lens, host, host_lens = scale_corpus(torch, g)
    del d
    rng = np.random.default_rng(seed + 17)
    qs = rng.standard_normal((c["queries"], c["nq"], c["dim"])).astype(np.float32)
    flt = Filter(must=[FieldCondition(key="doc", match=MatchValue(value=1))])
    points = [PointStruct(id=i, vector=host[i, : host_lens[i]], payload={"doc": i % 4})
              for i in range(c["pages"])]
    clients = {"mesh": VectorClient(device="cuda", mesh=mesh), "plain": VectorClient(device="cuda")}
    vp = VectorParams(size=c["dim"], multivector_config=MultiVectorConfig())
    for client in clients.values():
        for mode, kw in SCALE_MODES.items():
            client.create_collection(mode, vp, max_tokens=c["nt"], **kw)
    # one upsert through the client (phase 4 times that path); the other five
    # collections take its host copy as it is: this phase is about the queries
    clients["plain"].upsert("exact", points)
    first = clients["plain"]._get("exact")
    for client in clients.values():
        for mode in SCALE_MODES:
            st = client._get(mode)
            if st is not first:
                st._vectors, st._lens, st._ids = first._vectors, first._lens, first._ids
                st._payloads, st._id_to_idx = first._payloads, first._id_to_idx
    del points
    setup_s = time.perf_counter() - t0
    wrappers = kernel_wrappers()
    results, ms, worst = {}, {}, 0.0
    for who in ("mesh", "plain"):
        if who == "mesh":
            reset_counts(wrappers)
        for mode in SCALE_MODES:
            out = [clients[who].query_points(mode, q, limit=c["limit"],
                                             query_filter=flt if i == 3 else None)
                   for i, q in enumerate(qs)]     # the first query uploads the collection
            torch.cuda.synchronize()
            results[who, mode] = [[(p.id, p.score) for p in r.points] for r in out]
        if who == "mesh":
            launches = read_counts(wrappers)
    for mode in SCALE_MODES:
        for got, want in zip(results["mesh", mode], results["plain", mode]):
            require([i for i, _ in got] == [i for i, _ in want] and len(got) == c["limit"],
                    f"(a) {mode}: sharded ids {got} differ from the mesh-less store's {want}")
            for (_, a), (_, b) in zip(got, want):
                require(abs(a - b) <= 1e-3 * abs(b), f"(a) {mode}: score {a} vs {b}")
                worst = max(worst, abs(a - b))
        require(all(i % 4 == 1 for i, _ in results["mesh", mode][3]),
                f"(a) {mode}: the filtered query returned another document")

        def one_round(who, mode=mode):   # the queries' time a query, the collection already up
            t1 = time.perf_counter()
            for i, q in enumerate(qs):
                clients[who].query_points(mode, q, limit=c["limit"],
                                          query_filter=flt if i == 3 else None)
            return 1e3 * (time.perf_counter() - t1) / len(qs)

        for who, xs in interleaved(c["repeats"], {w: (lambda w=w: one_round(w))
                                                  for w in ("mesh", "plain")}).items():
            ms[who, mode] = xs
    require(launches["maxsim"] > 0 and launches["maxsim_int8"] > 0,
            f"(a) the sharded queries never launched K1 and K4: {launches}")
    del clients
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    # the rows are unit tokens with zero padding already
    view = DistributedCorpusView(host, host_lens, mesh=mesh, prefilter="pooled",
                                 normalize=False)
    view_s = time.perf_counter() - t1
    agree = 0
    for q in qs:
        vals, ids = view.query(q, limit=c["limit"], oversampling=2.0)
        qn = torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True)).cuda()
        wv, wi = T2.two_stage_maxsim_topk(qn, c["nq"], view.pooled, view.d_int8, view.d_scale,
                                          view.d_lens, k=c["limit"], n_candidates=2 * c["limit"],
                                          d_full=view.d)
        require(ids.tolist() == wi.cpu().tolist(),
                f"(a) the view's ids {ids.tolist()} differ from the single-device two-stage "
                f"search's {wi.cpu().tolist()}")
        agree += 1
    # whether the card's matrix-vector products score a page alike wherever
    # it sits (the CPU path reduces row by row for that): three shards of the
    # pooled index against the same rows of the whole
    from multimodal_colpali_tpu_torch.store.dense import scores_f32

    qn = torch.from_numpy(qs[0] / np.linalg.norm(qs[0], axis=-1, keepdims=True)).cuda()
    whole_c = T2._coarse_scores(qn, c["nq"], view.pooled, view.d_lens)[0]
    whole_d = scores_f32(view.pooled, qn[0])
    alike = {"coarse": True, "dense": True}
    for lo, n in ((0, c["shard"]), (c["shard"], c["shard"]), (c["pages"] - c["shard"] + 3,
                                                             c["shard"] - 3)):
        part = view.pooled[lo: lo + n]
        alike["coarse"] &= torch.equal(
            T2._coarse_scores(qn, c["nq"], part, view.d_lens[lo: lo + n])[0], whole_c[lo: lo + n])
        alike["dense"] &= torch.equal(scores_f32(part, qn[0]), whole_d[lo: lo + n])
    del view, host
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[scale-a] {c['pages']} pages x {c['nt']} x {c['dim']} (ragged {c['nt'] // 4}-{c['nt']}) in "
          f"exact / int8 / pooled collections of VectorClient(mesh=) and VectorClient(), built "
          f"and loaded in {setup_s:.1f} s: ids equal, max |score diff| {worst:.3g} (limit rtol "
          f"1e-3) | query ms a query, median [min-max] of {c['repeats']} interleaved rounds of "
          f"{c['queries']} (mesh / mesh-less): "
          + ", ".join(f"{m} {spread(ms['mesh', m])} / {spread(ms['plain', m])}"
                      for m in SCALE_MODES)
          + f" | DistributedCorpusView built in {view_s:.1f} s, {agree} queries equal to the "
          f"single-device two-stage search | shards of {c['shard']} / {c['shard'] - 3} rows "
          f"bit-equal to the whole index's rows: coarse GEMV {alike['coarse']}, bf16 dense mm "
          f"{alike['dense']} | launches {json.dumps(launches)} | {card}", flush=True)
    return dict(launches=launches, ms={f"{w}.{m}": v for (w, m), v in ms.items()}, alike=alike)


def scale_embed(torch, card: str, mesh, seed: int) -> dict:
    """(b): data-parallel ColSmol against the mesh-less retriever."""
    import numpy as np
    from multimodal_colpali_tpu_torch.models import load_retriever

    wrappers = kernel_wrappers()
    retr = {m: load_retriever(COLSMOL, device="cuda", dtype=torch.bfloat16, seed=seed,
                              device_preprocess=True, mesh=mesh if m == "mesh" else None)
            for m in ("mesh", "plain")}
    size = retr["plain"].processor.image_preprocessor.image_size
    pages = synthetic_pages(SMOL_PAGES, size, seed + 1)
    embs = {}
    for who in ("plain", "mesh"):
        retr[who].embed_images(pages[:SMOL_BATCH], batch_size=SMOL_BATCH)   # warm-up
        torch.cuda.synchronize()
        if who == "mesh":
            reset_counts(wrappers)
        embs[who] = retr[who].embed_images(pages, batch_size=SMOL_BATCH)
        if who == "mesh":
            launches = read_counts(wrappers)

    def pages_s(who):
        t0 = time.perf_counter()
        retr[who].embed_images(pages, batch_size=SMOL_BATCH)     # ends on the host
        return len(pages) / (time.perf_counter() - t0)

    rate = interleaved(SCALE["embed_repeats"], {w: (lambda w=w: pages_s(w))
                                                for w in ("mesh", "plain")})
    require(all(np.array_equal(a, b) for a, b in zip(embs["mesh"], embs["plain"]))
            and len(embs["mesh"]) == SMOL_PAGES,
            "(b) the data-parallel embeddings differ from the mesh-less retriever's")
    require(launches["vit_layer"] > 0 and launches["normalize"] > 0,
            f"(b) the data-parallel embedding never launched K5a and K3: {launches}")
    del retr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[scale-b] {COLSMOL} data-parallel over a 'data' axis of 1: {SMOL_PAGES} pages "
          f"bit-equal to the mesh-less retriever | pages/s, median [min-max] of "
          f"{SCALE['embed_repeats']} interleaved runs (mesh / mesh-less) {spread(rate['mesh'])} / "
          f"{spread(rate['plain'])} | launches {json.dumps(launches)} | {card}",
          flush=True)
    return dict(launches=launches, pages_s=rate)


def scale_serve(torch, engine, tok, kv_dtype: str, prompts):
    """``prompts`` (chat texts) at once through a paged batcher and the
    server over ``engine`` -> (token streams, decode tokens/s, launches)."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_colpali_tpu_torch.generation import GenerationServer, PagedContinuousBatcher

    c = SCALE
    wrappers = kernel_wrappers()
    bat = PagedContinuousBatcher(engine, batch_slots=c["slots"], max_seq_len=c["max_seq_len"],
                                 chunk=c["chunk"], page_size=c["page"], kv_dtype=kv_dtype,
                                 eos_id=tok.eos_id).serve()
    srv = GenerationServer(bat, tok, model_name=GEN_MODEL, host="127.0.0.1", port=0).start()
    body = lambda text: {"messages": [{"role": "user", "content": text}],  # noqa: E731
                         "max_tokens": c["new_tokens"]}
    try:
        require(chat(srv.base_url, dict(body("warm"), max_tokens=2))[0] == 200,
                "(c) warm-up request failed")
        torch.cuda.synchronize()
        bat.decode_s, bat.decode_tokens = 0.0, 0
        reset_counts(wrappers)
        with ThreadPoolExecutor(len(prompts)) as ex:
            outs = list(ex.map(lambda p: chat(srv.base_url, body(p)), prompts))
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
    finally:
        srv.stop()
        bat.shutdown()
    streams = []
    for status, text, finish, _ in outs:
        require(status == 200 and finish == "length", f"(c) a request failed: {status} {text!r}")
        streams.append([int(t) for t in text.split()])
    rate = bat.decode_tokens / bat.decode_s if bat.decode_s else 0.0
    del srv, bat
    gc.collect()
    torch.cuda.empty_cache()
    return streams, rate, launches


def scale_decode(torch, card: str, mesh, seed: int) -> dict:
    """(c): tensor-parallel gemma-3-27b against the mesh-less engine."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        GemmaDecodeEngine, ModuloTokenizer, render_chat_prompt)
    from multimodal_colpali_tpu_torch.models.registry import GEMMA3_CONFIGS, load_gemma3_lm

    c = SCALE
    rng = np.random.default_rng(seed + 23)
    prompts = [mcq_prompt(rng, n) for n in (320, 700, 1100, 1550)]
    runs, notes, rates, decode, kept = {}, [], {}, {}, {}
    for wd, kv in (("native", "native"), ("native", "int8"), ("int8", "native")):
        if kv == "native":
            with cut_depth(GEMMA3_CONFIGS, GEN_MODEL, c["depth"]):
                cfg, params, _ = load_gemma3_lm(GEN_MODEL, device="cuda", dtype=torch.bfloat16,
                                                seed=seed, weight_dtype=wd)
            plain = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, device="cuda")
            tp = GemmaDecodeEngine(cfg, params, dtype=torch.bfloat16, device="cuda", mesh=mesh)
            tok = ModuloTokenizer(cfg.vocab_size)
            ids = [tok.encode(render_chat_prompt([{"role": "user", "content": p}]),
                              add_special_tokens=True) for p in prompts]
            want = plain.generate(ids, max_new_tokens=c["new_tokens"], eos_id=tok.eos_id)
        tag = f"{wd} weights, {kv} pools"
        got, rates[tag], runs[tag] = scale_serve(torch, tp, tok, kv, prompts)
        if wd == kv == "native":    # decode alone, mesh against mesh-less, bf16 only
            decode = scale_decode_rates(torch, {"mesh": tp, "plain": plain}, ids)
            kept = {"mesh": tp, "plain": plain, "tok": tok}     # part (f) serves on them
        for i, (a, b) in enumerate(zip(got, want)):
            div = first_divergence(plain, ids[i], a, b)
            if div is not None:
                require(div[1] <= 0.05, f"(c) {tag}: a {len(ids[i])}-token stream first "
                                        f"differs at step {div[0]}, top-2 gap {div[1]:.4f}")
                notes.append(f"{tag} {len(ids[i])} tok: differs at {div[0]} (gap {div[1]:.4f})")
        if kv == "int8" or wd == "int8":
            del plain, tp, params
            gc.collect()
            torch.cuda.empty_cache()
    # what a one-rank NCCL all-reduce costs in a step-like stream of work (the
    # paths skip a collective over one rank, parallel/mesh): 16 small launches
    # that hold the host, one matmul that holds the card, then the collective
    import torch.distributed as dist

    group = mesh.groups["model"]
    xs = torch.randn(c["slots"], 1, K8["h"], device="cuda").to(torch.bfloat16)
    xb = torch.randn(2048, K8["h"], device="cuda").to(torch.bfloat16)
    w = torch.randn(K8["h"], K8["h"], device="cuda").to(torch.bfloat16)

    def loop_ms(ar: bool) -> float:      # host ms an iteration of 100
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            for _ in range(16):
                y = xs * 1.0
            xb @ w
            if ar:
                dist.all_reduce(y, group=group)
        torch.cuda.synchronize()
        return 10 * (time.perf_counter() - t0)

    loop_ms(True)
    ar_ms = interleaved(3, {"with": lambda: loop_ms(True), "without": lambda: loop_ms(False)})
    r = runs
    require(r["native weights, native pools"]["paged_attention.tensor_core"] > 0,
            "(c) the tensor-parallel engine never launched K7a's tensor-core path")
    require(r["native weights, int8 pools"]["paged_attention_int8.tensor_core"] > 0,
            "(c) the tensor-parallel engine never launched K7b's tensor-core path")
    k8 = r["int8 weights, native pools"]
    require(k8["int8_matmul_kn.decode"] > 0 and k8["int8_matmul_kn.prefill"] > 0
            and k8["int8_matmul_nk"] > 0,
            f"(c) the int8 tensor-parallel engine never launched both K8a tiles and K8b: {k8}")
    print(f"[scale-c] {GEN_MODEL} full width, {c['depth']} layers, over a ('data', 'model') mesh "
          f"of (1, 1): 4 greedy requests of {c['new_tokens']} tokens through "
          f"PagedContinuousBatcher + GenerationServer equal the mesh-less generate "
          f"({'; '.join(notes) or 'all identical'}) | served decode tokens/s (mesh): "
          + ", ".join(f"{t} {rates[t]:.1f}" for t in runs)
          + f" | bf16 decode alone, tokens/s, median [min-max] of {c['rate_repeats']} "
          f"interleaved runs of 4 x {c['rate_tokens']} new tokens (mesh / mesh-less): "
          f"{spread(decode['mesh'])} / {spread(decode['plain'])}"
          + f" | a loop of 16 small launches and a [2048, {K8['h']}] x [{K8['h']}, {K8['h']}] "
          f"matmul, host ms an iteration (median [min-max] of 3 interleaved runs of 100): with a "
          f"1-rank NCCL all-reduce of [{c['slots']}, 1, {K8['h']}] bf16 after each "
          f"{spread(ar_ms['with'])}, without {spread(ar_ms['without'])} | {card}", flush=True)
    return dict(runs=runs, rates=rates, decode=decode, all_reduce_ms=ar_ms, engines=kept)


def scale_decode_rates(torch, engines: dict, ids) -> dict:
    """Decode tokens/s of the prompts ``ids`` through a paged batcher over
    each of two engines, interleaved: ``rate_tokens`` greedy tokens a
    request (no eos), the batcher's decode-step clock alone (no prefill)."""
    from multimodal_colpali_tpu_torch.generation import PagedContinuousBatcher

    c = SCALE
    bats = {w: PagedContinuousBatcher(e, batch_slots=c["slots"], max_seq_len=c["max_seq_len"],
                                      chunk=c["chunk"], page_size=c["page"])
            for w, e in engines.items()}

    def tokens_s(who):
        b = bats[who]
        b.decode_s, b.decode_tokens = 0.0, 0
        b.generate(ids, max_new_tokens=c["rate_tokens"])
        return b.decode_tokens / b.decode_s

    for b in bats.values():
        b.generate(ids[:1], max_new_tokens=2)      # warm-up
    out = interleaved(c["rate_repeats"], {w: (lambda w=w: tokens_s(w)) for w in bats})
    del bats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scale_kernels(torch, g) -> dict:
    """(d): the kernels at the shapes one rank of tp = 2 and 4 gives them ->
    (rows, launches). One card runs no main path at these shapes, so a row's
    ``launches`` are its checks' launches at its shape (the timing's are left
    out), counted by the wrapper's counters around them."""
    from multimodal_colpali_tpu_torch._timing import eager_ms, graph_ms
    from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
    from multimodal_colpali_tpu_torch.ops import maxsim as M
    from multimodal_colpali_tpu_torch.ops import paged_attention as PA

    dev = torch.device("cuda")
    results, launches, rtol = {}, {}, 2.0 ** -7
    int8pack = library_op(torch, "_weight_int8pack_mm")
    wrappers = kernel_wrappers()
    d, page, nb, lengths = K7["d"], K7["page"], 128, [309, 709, 1109, 1509]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = 168.0 ** -0.5
    for tp, hq, hkv in ((2, 16, 8), (4, 8, 4)):
        n_pages = 4 * nb + 1
        q = torch.randn(4, hq, d, generator=g, device=dev).to(torch.bfloat16)
        kp, vp = (torch.randn(n_pages, page, hkv, d, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        bt = torch.randperm(n_pages, generator=g, device=dev)[: 4 * nb].reshape(4, nb).int()
        i8 = (*PA.quantize_kv_rows(kp), *PA.quantize_kv_rows(vp))
        for name, floor, atol, per_row, call, plain in (
                ("paged_attention", 2e-2, 2e-3, 2 * d,
                 lambda w: PA.paged_attention_cuda(q, kp, vp, bt, lens, scale=scale, window=w),
                 lambda w: PA.paged_attention_reference(q, kp, vp, bt, lens, scale=scale,
                                                        window=w)),
                ("paged_attention_int8", 0.035, 4e-3, d + 4,
                 lambda w: PA.paged_attention_int8_cuda(q, *i8, bt, lens, scale=scale, window=w),
                 lambda w: PA.paged_attention_int8_reference(q, *i8, bt, lens, scale=scale,
                                                             window=w))):
            errs, before = [], wrappers[name].launches
            for window in (0, 1024):
                got, want = call(window).float(), plain(window).float()
                diff = (got - want).abs()
                errs.append(float(diff.max()))
                excess = float((diff - rtol * want.abs()).max())
                require(errs[-1] <= floor and excess <= atol,
                        f"(d) {name} at {hq}/{hkv} heads window {window}: max|err| {errs[-1]}, "
                        f"max(|err| - {rtol:.4g}|want|) {excess} > {atol}")
            launches[f"{name}.tp{tp}"] = wrappers[name].launches - before
            k_ms = graph_ms(lambda: call(0), iters=20)
            _, p_ms = timed_pair(torch, lambda: call(0), lambda: plain(0), iters=5)
            nbytes = sum(2 * n for n in lengths) * hkv * per_row + 2 * q.numel() * 2
            r = row(max(errs), k_ms, p_ms, nbytes, 4.0 * hq * d * sum(lengths))
            results[f"{name}.tp{tp}"] = r
            print(f"[scale-d] {name} q {list(q.shape)} pools [{n_pages}, {page}, {hkv}, {d}] "
                  f"lengths {lengths}, windows 0 and 1024: max|err| {max(errs):.3g} (floor "
                  f"{floor}) | kernel {k_ms:.4f} ms (graph), plain {p_ms:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        del q, kp, vp, i8
    h = K8["h"]
    slices = [(h, 2048), (h, 1024), (h, 10752), (h, 5376),
              (2048, h), (1024, h), (10752, h), (5376, h)]
    for m, tile in ((8, "decode"), (512, "prefill")):
        errs, first, n_checks = [], None, 0
        for k, n in slices:
            w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
            sc = torch.rand(n, generator=g, device=dev) * 1e-3
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            before = getattr(IM.int8_matmul_kn_cuda, f"{tile}_launches")
            got = IM.int8_matmul_kn_cuda(x, w, sc).float()
            require(getattr(IM.int8_matmul_kn_cuda, f"{tile}_launches") == before + 1,
                    f"(d) K8a [{m}, {k}] x [{k}, {n}] did not take its {tile} tile")
            n_checks += 1
            want = IM.int8_matmul_reference(x, w, sc).float()
            err = float((got - want).abs().max())
            require(err <= 0.02 * float(want.abs().max()),
                    f"(d) K8a [{m}, {k}] x [{k}, {n}]: max|err| {err} > 2% of max")
            errs.append(err)
            if first is None:
                k_ms = graph_ms(lambda: IM.int8_matmul_kn_cuda(x, w, sc), iters=20)
                _, p_ms = timed_pair(torch, lambda: IM.int8_matmul_kn_cuda(x, w, sc),
                                     lambda: IM.int8_matmul_reference(x, w, sc), iters=5)
                lib_ms = None
                if int8pack:    # the yardstick x @ w[N, K]^T * scale[N], timed only
                    w_nk, s_x = w.t().contiguous(), sc.to(x.dtype)
                    lib_ms = eager_ms(lambda: int8pack(x, w_nk, s_x), iters=10 if m <= 16 else 2)
                first = (k, n, k_ms, p_ms, w.numel() + n * 4 + m * (k + n) * 2, 2.0 * m * k * n,
                         lib_ms)
        k, n, k_ms, p_ms, nbytes, flops, lib_ms = first
        name = "int8_matmul_kn.tp" if tile == "decode" else "int8_matmul_kn.prefill.tp"
        results[name] = row(max(errs), k_ms, p_ms, nbytes, flops, library_ms=lib_ms)
        launches[name] = n_checks
        print(f"[scale-d] K8a {tile} tile ([{m}, K] rows) on the column slices 5376 -> 2048, "
              f"1024, 10752, 5376 and the row slices 2048, 1024, 10752, 5376 -> 5376: max|err| "
              f"{max(errs):.3g} (limit 2% of max) | [{m}, {k}] x [{k}, {n}]: kernel {k_ms:.4f} ms "
              f"(graph), plain {p_ms:.3f} ms, _weight_int8pack_mm "
              f"{'none on this torch' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
              f"{results[name]['bound_ms']:.4f} ms ({results[name]['bound_by']})", flush=True)
    c = SCALE
    q = torch.randn(1, c["nq"], c["dim"], generator=g, device=dev)
    q = torch.nn.functional.normalize(q, dim=-1)
    for p in (c["shard"], c["shard"] - 3):
        pages = torch.nn.functional.normalize(torch.randn(p, c["nt"], c["dim"], generator=g,
                                                          device=dev), dim=-1).to(torch.bfloat16)
        dl = torch.randint(1, c["nt"] + 1, (p,), generator=g, device=dev, dtype=torch.int32)
        codes, scales = M.quantize_corpus_int8(pages)
        for name, call, plain, rt in (
                ("maxsim", lambda: M.maxsim_scores_cuda(q.to(torch.bfloat16), pages, None, dl),
                 lambda: M.maxsim_scores_reference(q.to(torch.bfloat16), pages, None, dl), 1e-3),
                ("maxsim_int8", lambda: M.maxsim_scores_int8_cuda(q, codes, scales, None, dl),
                 lambda: M.maxsim_scores_int8_reference(q, codes, scales, None, dl), 1e-4)):
            before = wrappers[name].launches
            got, want = call(), plain()
            launches[f"{name}.shard"] = (launches.get(f"{name}.shard", 0)
                                         + wrappers[name].launches - before)
            require(torch.allclose(got, want, rtol=rt, atol=rt if name == "maxsim" else 0),
                    f"(d) {name} on a shard of {p} pages differs beyond rtol {rt}")
            err = float((got - want).abs().max())
            if p == c["shard"]:
                k_ms = graph_ms(call, iters=20)
                _, p_ms = timed_pair(torch, call, plain, iters=3)
                live = float(dl.sum())
                per = c["dim"] * 2 if name == "maxsim" else c["dim"] + 4
                results[f"{name}.shard"] = row(err, k_ms, p_ms, live * per + q.numel() * 4 + p * 4,
                                               2.0 * c["dim"] * c["nq"] * live)
            else:
                results[f"{name}.shard"]["max_abs_err"] = max(
                    results[f"{name}.shard"]["max_abs_err"], err)
        del pages, codes, scales
    for name in ("maxsim.shard", "maxsim_int8.shard"):
        print(f"[scale-d] {name} one query of {c['nq']} over {c['shard']} and {c['shard'] - 3} "
              f"pages of up to {c['nt']}: max|err| {results[name]['max_abs_err']:.3g} | kernel "
              f"{results[name]['ms']:.4f} ms (graph), plain {results[name]['plain_ms']:.3f} ms, "
              f"bound {results[name]['bound_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    require(all(n > 0 for n in launches.values()), f"(d) a kernel never launched: {launches}")
    return results, launches


# phase 17 (f): the batchers' admission records on the mesh's leader. Gemma-3
# with images on part (c)'s engines (4 slots of 2,048; SigLIP-So400m at 896
# px); Llama-3.2-11B-Vision cut to the first 10 of its 40 decoder layers (8
# self, the cross layers at 3 and 8; its whole tower) behind the dense batcher
SERVE_MM = dict(slots=4, max_seq_len=2048, chunk=8, page=16, new_tokens=16, mcq_tokens=8,
                text_tokens=(300, 700), repeats=8, mllama_self=8, mllama_cross=(3, 8),
                mllama_slots=4, mllama_seq=512, mllama_tokens=8, mllama_images=2,
                g3_slots=8, g3_seq=8192)


def serve_burst(torch, bat, mm, pre, tok, requests, name: str, count: bool = False):
    """``requests`` ([(key, chat body)]) at once through the port's client
    to a ``GenerationServer`` over ``bat`` (started with ``serve()``) ->
    (key -> reply text, {"ttft_ms": median TTFT of the burst's generations,
    "tokens_s": decode tokens/s, "step_ms": ms a decode step, "live": decode
    tokens a step (the slots live on average), "records", "forwards"}, launch
    counts or None). Stops the server and the batcher. tokens/s = live *
    1,000 / step_ms: a burst whose requests reach their slots at other
    times decodes with fewer slots live at the same step time."""
    import asyncio
    import statistics

    from multimodal_colpali_tpu_torch.generation import (
        GenerationServer, post_request_with_retries_raising, run_sync)
    from multimodal_colpali_tpu_torch.generation.client import ClientSession

    wrappers = kernel_wrappers()
    srv = GenerationServer(bat, tok, model_name=name, host="127.0.0.1", port=0, mm_engine=mm,
                           image_preprocessor=pre).start()
    url, headers = srv.base_url + "/chat/completions", {"Content-Type": "application/json"}

    async def burst():
        async with ClientSession(limit=len(requests)) as session:
            return await asyncio.gather(*(post_request_with_retries_raising(
                session, url, headers, dict(body, model=name), retries=1)
                for _, body in requests))

    launches = None
    try:
        torch.cuda.synchronize()
        if count:
            reset_counts(wrappers)
        replies = run_sync(burst())
        torch.cuda.synchronize()
        if count:
            launches = read_counts(wrappers)
    finally:
        srv.stop()
        bat.shutdown()
    stats = {"ttft_ms": 1e3 * statistics.median(bat.ttft_s),
             "tokens_s": bat.decode_tokens / bat.decode_s if bat.decode_s else 0.0,
             "step_ms": 1e3 * bat.decode_s / max(bat.decode_steps, 1),
             "live": bat.decode_tokens / max(bat.decode_steps, 1), "records": bat.records, "forwards": bat.constrained_forwards}
    return dict(zip([k for k, _ in requests], replies)), stats, launches


def served_alike(tag: str, mm, tok, pre, requests, got: dict, want: dict, n_tokens: int) -> str:
    """The mesh server's replies against the mesh-less server's: each greedy
    stream identical, or first different where the mesh-less engine's top
    two logits are within 0.05 (phase 5's tie rule); the MCQ the same
    choice, or one whose two best choices are within 0.05."""
    import numpy as np
    from multimodal_colpali_tpu_torch.generation import GenerationServer, extract_chat_content

    notes, probe = [], None
    for key, body in requests:
        a, b = got[key], want[key]
        if key == "mcq":
            require(json.loads(a).get("answer") in ("A", "B", "C", "D"),
                    f"[{tag}] the MCQ reply is not a choice: {a!r}")
        else:
            require(len(a.split()) == n_tokens, f"[{tag}] {key}: {len(a.split())} tokens")
        if a == b:
            notes.append(f"{key}: identical")
            continue
        if probe is None:        # an unstarted server over the mesh-less engine: its prompts
            probe = GenerationServer(mm.lm, tok, host="127.0.0.1", port=0, mm_engine=mm,
                                     image_preprocessor=pre)
            probe._httpd.server_close()
        prompt, images = extract_chat_content(body["messages"])
        if key == "mcq":
            field, choices = probe._schema_enum(body)
            scaffold, ids, firsts = probe._constrained_prompt(prompt, field, choices)
            if images:
                ids = mm.build_mm_prompt(probe._encode(scaffold), bos_id=tok.bos_id,
                                         n_images=len(images))
                logits = mm.next_token_logits([ids], pre(images)[None])[0]
            else:
                logits = mm.lm.next_token_logits([ids])[0]
            top2 = np.sort(logits[firsts])[-2:]
            require(top2[1] - top2[0] <= 0.05, f"[{tag}] the MCQ answers {a!r} / {b!r}, its "
                                               f"choices {top2[1] - top2[0]:.4f} apart (> 0.05)")
            notes.append(f"mcq: differs (choices {top2[1] - top2[0]:.4f} apart)")
            continue
        ids, pix = probe._prepare_ids(prompt, images)
        eng = mm.lm
        eng.record_top2 = True
        (eng.generate([ids], max_new_tokens=n_tokens, eos_id=tok.eos_id) if pix is None
         else mm.generate([ids], pix[None], max_new_tokens=n_tokens, eos_id=tok.eos_id))
        gaps, eng.record_top2 = eng.top2_gaps[0], False
        notes.append(check_greedy(tag, key, [int(t) for t in a.split()],
                                  [int(t) for t in b.split()], lambda i: float(gaps[i]),
                                  n=n_tokens))
    return "; ".join(notes)


def dense_bytes(bat) -> int:
    """The bytes of a dense batcher's caches and cross pools on this rank."""
    ts = [*bat._kc, *bat._vc, *(getattr(bat, n) for n in ("_cross_k", "_cross_v")
                                if hasattr(bat, n))]
    return sum(t.numel() * t.element_size() for t in ts)


def per_rank(nbytes: int, slots: int, dp: int) -> float:
    """GiB a data rank holds of dense caches of ``nbytes`` over ``slots``:
    its ``slots / dp`` slots, or every slot where ``dp`` does not divide them."""
    return nbytes * (slots // dp if slots % dp == 0 else slots) / slots / 2**30


def scale_serving(torch, card: str, mesh, seed: int, engines: dict) -> dict:
    """(f): ``GenerationServer`` over batchers on the (1, 1) mesh's leader
    path against the mesh-less server. Gemma-3 with images on part (c)'s
    engines, a 1-image, a 5-image, two text requests and an MCQ over the 5
    images sent at once through the port's client; Llama-3.2-11B-Vision cut
    in depth, a 2-image request behind the dense batcher; the dense caches'
    bytes. -> {"launches", "mllama"} (the two mesh runs' counts)."""
    import warnings

    import numpy as np
    from multimodal_colpali_tpu_torch.generation import (
        ContinuousBatcher, Gemma3MMEngine, LlamaDecodeEngine, MllamaImagePreprocessor,
        MllamaMMEngine, PagedContinuousBatcher)
    from multimodal_colpali_tpu_torch.models import registry as R
    from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor

    c, bf16 = SERVE_MM, torch.bfloat16
    t0 = time.perf_counter()
    tok = engines["tok"]
    with cut_depth(R.GEMMA3_MM_CONFIGS, GEN_MODEL, SCALE["depth"]):
        g3 = R.GEMMA3_MM_CONFIGS[GEN_MODEL]()
    require(g3.text == engines["plain"].cfg, "(f) part (c)'s engine is not gemma-3-27b's LM")
    tower, projector = R._vision_parts(g3, torch.device("cuda"), bf16, seed=seed)
    mms = {w: Gemma3MMEngine(g3, tower, projector, lm=engines[w]) for w in ("mesh", "plain")}
    pre = ImagePreprocessor(g3.vision.image_size)
    rng = np.random.default_rng(seed + 29)
    pages = [png_url(p) for p in synthetic_pages(5, g3.vision.image_size, seed + 30)]

    def with_images(n, text):
        return [{"type": "image_url", "image_url": {"url": u}} for u in pages[:n]] + [
            {"type": "text", "text": text}]

    requests = [("1 image", with_images(1, QUESTION)), ("5 images", with_images(5, QUESTION)),
                *((f"text {n}", mcq_prompt(rng, n)) for n in c["text_tokens"])]
    requests = [(k, {"messages": [{"role": "user", "content": m}], "max_tokens": c["new_tokens"]})
                for k, m in requests]
    requests.append(("mcq", {"messages": [{"role": "user", "content": with_images(
        5, mcq_prompt(rng, 200))}], "max_tokens": c["mcq_tokens"], "response_format": MCQ_FORMAT}))

    def batcher(who):
        return PagedContinuousBatcher(mms[who].lm, batch_slots=c["slots"],
                                      max_seq_len=c["max_seq_len"], chunk=c["chunk"],
                                      page_size=c["page"], mm_engine=mms[who],
                                      eos_id=tok.eos_id).serve()

    # the main path: the mesh server's first burst, its launches counted
    got, first, launches = serve_burst(torch, batcher("mesh"), mms["mesh"], pre, tok, requests,
                                       GEN_MODEL, count=True)
    want, _, _ = serve_burst(torch, batcher("plain"), mms["plain"], pre, tok, requests,
                             GEN_MODEL)
    notes = served_alike("scale-f", mms["plain"], tok, pre, requests, got, want,
                         c["new_tokens"])
    require(first["records"] > 0 and first["forwards"] == 1,
            f"(f) the mesh batcher applied {first['records']} records, "
            f"{first['forwards']} constrained forwards")
    require(launches["attention.tensor_core"] > 0 and launches["paged_attention.tensor_core"] > 0,
            f"(f) the mesh server never launched K2's or K7a's tensor-core path: {launches}")
    readings = interleaved(c["repeats"], {w: (lambda w=w: serve_burst(
        torch, batcher(w), mms[w], pre, tok, requests, GEN_MODEL)[1]) for w in ("mesh", "plain")})
    del mms, tower, projector, engines
    gc.collect()
    torch.cuda.empty_cache()
    g3_s = time.perf_counter() - t0

    # Llama-3.2-11B-Vision, cut in depth, behind the dense batcher
    t1 = time.perf_counter()
    full = R.MLLAMA_CONFIGS[MLLAMA]
    cut = dataclasses.replace(full(), text=dataclasses.replace(
        full().text, num_hidden_layers=c["mllama_self"]), cross_attention_layers=c["mllama_cross"])
    R.MLLAMA_CONFIGS[MLLAMA] = lambda: cut
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")             # random weights: the init warns
            cfg, params, _ = R.load_mllama_mm(MLLAMA, device="cuda", dtype=bf16, seed=seed)
    finally:
        R.MLLAMA_CONFIGS[MLLAMA] = full
    mpre = MllamaImagePreprocessor(cfg, tiles=(1, 1), device="cuda")
    mm_ll = {w: MllamaMMEngine(cfg, params["vision_tower"], params["multi_modal_projector"],
                               params["cross_layers"],
                               LlamaDecodeEngine(cfg.text, params, dtype=bf16, device="cuda",
                                                 mesh=mesh if w == "mesh" else None),
                               tiles=(1, 1)) for w in ("mesh", "plain")}
    n_img = c["mllama_images"]
    mreq = [("2 images", {"messages": [{"role": "user", "content": [
        *({"type": "image_url", "image_url": {"url": png_url(p)}}
          for p in synthetic_pages(n_img, OLD_SIZE["mllama"], seed + 31)),
        {"type": "text", "text": QUESTION}]}], "max_tokens": c["mllama_tokens"]})]
    bats = {w: ContinuousBatcher(mm_ll[w].lm, batch_slots=c["mllama_slots"],
                                 max_seq_len=c["mllama_seq"], chunk=c["chunk"], mm_engine=mm_ll[w],
                                 cross_max_images=n_img, eos_id=tok.eos_id)
            for w in ("mesh", "plain")}
    nbytes = {w: dense_bytes(b) for w, b in bats.items()}
    require(nbytes["mesh"] == nbytes["plain"] and bats["mesh"]._kc[0].shape[0] == c["mllama_slots"],
            f"(f) the (1, 1) mesh's dense batcher holds {nbytes['mesh']} bytes, the mesh-less "
            f"one {nbytes['plain']}")
    mtok = type(tok)(cfg.text.vocab_size)
    mgot, mstats, mlaunch = serve_burst(torch, bats["mesh"].serve(), mm_ll["mesh"], mpre, mtok,
                                        mreq, MLLAMA, count=True)
    mwant, _, _ = serve_burst(torch, bats["plain"].serve(), mm_ll["plain"], mpre, mtok, mreq,
                              MLLAMA)
    mnote = served_alike("scale-f", mm_ll["plain"], mtok, mpre, mreq, mgot, mwant,
                         c["mllama_tokens"])
    require(mstats["records"] > 0, "(f) the Mllama mesh batcher applied no record")
    del bats, mm_ll, params, mpre
    gc.collect()
    torch.cuda.empty_cache()
    ll_s = time.perf_counter() - t1

    gfull = R.GEMMA3_CONFIGS[GEN_MODEL]()
    g3_bytes = (2 * gfull.num_hidden_layers * c["g3_slots"] * c["g3_seq"]
                * gfull.num_key_value_heads * gfull.head_dim * 2)
    ms = c["mllama_slots"]
    print(f"[scale-f] {GEN_MODEL} ({SCALE['depth']} layers, part (c)'s engines) with "
          f"SigLIP-So400m at {g3.vision.image_size} px: a 1-image, a 5-image, two text requests "
          f"of {c['new_tokens']} tokens and an MCQ over the 5 images at once through the port's "
          f"client, PagedContinuousBatcher + GenerationServer over the (1, 1) mesh's leader path "
          f"against the mesh-less server: {notes} | {first['records']} records, "
          f"{first['forwards']} constrained forward | TTFT ms (median of a burst's 4 "
          f"generations), median [min-max] of {c['repeats']} interleaved bursts (mesh / "
          f"mesh-less) {spread([r['ttft_ms'] for r in readings['mesh']])} / "
          f"{spread([r['ttft_ms'] for r in readings['plain']])} | decode tokens/s "
          f"{spread([r['tokens_s'] for r in readings['mesh']])} / "
          f"{spread([r['tokens_s'] for r in readings['plain']])} | ms a decode step "
          f"{spread([r['step_ms'] for r in readings['mesh']])} / "
          f"{spread([r['step_ms'] for r in readings['plain']])} | slots live a step "
          f"{spread([r['live'] for r in readings['mesh']])} / "
          f"{spread([r['live'] for r in readings['plain']])} | launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} | {g3_s:.1f} s | {card}",
          flush=True)
    print(f"[scale-f] {MLLAMA} cut to {cfg.text.num_hidden_layers} self + "
          f"{len(cfg.cross_attention_layers)} cross layers (cross at "
          f"{list(cfg.cross_attention_layers)}; of 32 + 8), its whole tower "
          f"({cfg.vision.num_hidden_layers} + {cfg.vision.num_global_layers} layers), tiles 1x1: a "
          f"{n_img}-image request of {c['mllama_tokens']} tokens behind ContinuousBatcher "
          f"({ms} slots of {c['mllama_seq']}, cross pools of {n_img} images) + GenerationServer "
          f"on the mesh against the mesh-less server: {mnote}; {mstats['records']} records | "
          f"dense caches and cross pools {nbytes['mesh'] / 2**20:.1f} MiB on the (1, 1) mesh = "
          f"the mesh-less batcher's; a rank would hold {per_rank(nbytes['mesh'], ms, 2) * 1024:.1f}"
          f" / {per_rank(nbytes['mesh'], ms, 4) * 1024:.1f} MiB at dp = 2 / 4 | {GEN_MODEL} at "
          f"{gfull.num_hidden_layers} layers, {c['g3_slots']} slots of {c['g3_seq']} (by its "
          f"config, not allocated): {g3_bytes / 2**30:.2f} GiB of dense cache, a rank "
          f"{per_rank(g3_bytes, c['g3_slots'], 2):.2f} / {per_rank(g3_bytes, c['g3_slots'], 4):.2f}"
          f" GiB at dp = 2 / 4 | {ll_s:.1f} s | {card}", flush=True)
    return {"launches": launches, "mllama": mlaunch}


def params_of(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def scale_training(torch, card: str, mesh, seed: int, work: str) -> dict:
    """(e): DP x TP training at world size 1 (``training/`` on ``mesh``, the
    (1, 1) ``data`` x ``model`` mesh) -> {"launches": the full-depth path's
    counts, "rows", "row_launches": the K2 rows at tp = 2 and 4 and their
    checks' launches}."""
    import statistics

    from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
    from multimodal_colpali_tpu_torch.models.registry import (RETRIEVER_CONFIGS,
                                                              init_random_params_)
    from multimodal_colpali_tpu_torch.training import make_train_step, make_training_setup
    from multimodal_colpali_tpu_torch.training.checkpoint import (
        make_checkpoint_manager, restore_train_state, save_train_state)

    wrappers = kernel_wrappers()
    cfg = RETRIEVER_CONFIGS[COLPALI]()
    sv, st = TRAIN["depth"]
    small = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=sv),
        text=dataclasses.replace(cfg.text, num_hidden_layers=st))
    gc.collect()
    torch.cuda.empty_cache()
    with Float32Numerics(torch):
        batch = train_batch(torch, cfg, seed)

        def trainer(config, on_mesh: bool):
            model = ColPaliModel(config, device="cuda", dtype=torch.float32)
            init_random_params_(model, seed)
            m = mesh if on_mesh else None
            opt = make_training_setup(model, learning_rate=TRAIN["lr"], mesh=m)
            return model, opt, make_train_step(model, opt, mesh=m)

        # the (1, 1) mesh step against the mesh-less one, 2 + 2 layers
        runs = {who: trainer(small, who == "mesh") for who in ("plain", "mesh")}
        losses = {who: [float(stp(batch)) for _ in range(2)] for who, (_, _, stp) in runs.items()}
        p_plain, p_mesh = (params_of(runs[who][0]) for who in ("plain", "mesh"))
        diff = max(float((p_mesh[n] - w).abs().max()) for n, w in p_plain.items())
        bit = losses["mesh"] == losses["plain"] and diff == 0.0
        del p_plain, p_mesh
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["plain"]))
        require(rel <= TRAIN["loss_rel"] and diff <= 1e-6,
                f"(e) the (1, 1) mesh step differs from the mesh-less one: losses "
                f"{losses['mesh']} against {losses['plain']}, parameters by {diff}")
        mgr = make_checkpoint_manager(Path(work) / "mesh-ckpt", max_to_keep=1)
        model, opt, stp = runs["mesh"]
        save_train_state(mgr, 2, model, opt)

        def wall(who):
            t0 = time.perf_counter()
            runs[who][2](batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        first3 = float(runs["mesh"][2](batch))     # the uninterrupted step 3
        want = params_of(runs["mesh"][0])
        walls = interleaved(4, {w: (lambda w=w: wall(w)) for w in ("plain", "mesh")})
        del runs, model, opt, stp
        gc.collect()
        torch.cuda.empty_cache()
        model = ColPaliModel(small, device="cuda", dtype=torch.float32)
        opt = make_training_setup(model, learning_rate=TRAIN["lr"], mesh=mesh)
        require(restore_train_state(mgr, model, opt) == 2, "(e) restored the wrong step")
        r3 = float(make_train_step(model, opt, mesh=mesh)(batch))
        same = all(torch.equal(p.detach(), want[n]) for n, p in model.named_parameters())
        require(r3 == first3 and same, f"(e) the (1, 1) checkpoint's step 3 differs: loss {r3} "
                f"against {first3}, parameters {'equal' if same else 'differ'}")
        del model, opt, want
        shutil.rmtree(mgr.directory, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[scale-e] {sv} SigLIP + {st} Gemma layers, full width, float32: (1, 1) mesh "
              f"losses {losses['mesh']} against mesh-less {losses['plain']} (rel {rel:.2g}), "
              f"parameters within {diff:.3g} ({'bit-equal' if bit else 'not bit-equal'}); step "
              f"ms mesh {spread(walls['mesh'])}, mesh-less {spread(walls['plain'])} (median "
              f"[range] of 4 interleaved, steps 4-11); a (1, 1) checkpoint of step 2 resumed "
              f"step 3 bit for bit | {card}", flush=True)

        # the main path: the full model through the mesh step
        t0 = time.perf_counter()
        model, opt, stp = trainer(cfg, True)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        full, steps_s = [], []
        for i in range(2):
            t0 = time.perf_counter()
            full.append(float(stp(batch)))
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t0)
        path = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        require(finite and all(math.isfinite(x) for x in full) and full[1] < full[0],
                f"(e) full-depth mesh steps: losses {full}, gradients "
                f"{'finite' if finite else 'not finite'}")
        layers = cfg.vision.num_hidden_layers
        require(path["attention"] == path["attention.tf32"] == path["attention_backward"]
                == 2 * layers,
                f"(e) K2 launches: forward {path['attention']} (3xTF32 {path['attention.tf32']}), "
                f"backward {path['attention_backward']}, not {2 * layers} each")
        others = {k: n for k, n in path.items() if n and not k.startswith("attention")}
        require(not others, f"(e) unexpected kernels on the training path: {others}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[scale-e] {COLPALI} full depth on the (1, 1) mesh, {n_params / 1e9:.3f}B "
              f"parameters (built in {setup_s:.1f} s): 2 steps, losses {full}, step s "
              f"{[round(x, 3) for x in steps_s]}, peak {peak:.2f} GiB, K2 {path['attention']} "
              f"forward + {path['attention_backward']} backward launches | {card}", flush=True)
        del model, opt, stp, batch
        gc.collect()
        torch.cuda.empty_cache()

        rows, row_launches = {}, {}
        g = torch.Generator(device="cuda").manual_seed(seed + 23)
        for tp in (2, 4):
            got = k2_training_rows(torch, g, heads=K2_TRAIN["h"] // tp, tag=f".tp{tp}")
            for name, r in got.items():
                row_launches[name] = r.pop("check_launches")
                require(row_launches[name] > 0, f"(e) {name}: no launch")
            rows.update(got)
    return {"launches": path, "rows": rows, "row_launches": row_launches}


def phase_scaleout(torch, seed: int, card: str, work: str) -> dict:
    """Phase 17: the mesh paths at world size 1 over NCCL, each against its
    mesh-less twin (serving over the batchers' admission records too), and
    the kernels at a rank's shapes of tp = 2 and 4."""
    import torch.distributed as dist
    from multimodal_colpali_tpu_torch.parallel import get_mesh, initialize_distributed

    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    walls = {}
    initialize_distributed(f"file://{work}/scaleout-rendezvous", 1, 0, device="cuda")
    try:
        require(dist.get_backend() == "nccl", "phase 17: the group is not NCCL")
        corpus, dm = get_mesh(("corpus",)), get_mesh(("data", "model"), (1, 1))
        out = {}
        # (f) serves on (c)'s engines, and frees them before (d) and (e)
        for part, fn, args in (("a", scale_store, lambda: (corpus, seed, g)),
                               ("b", scale_embed, lambda: (dm, seed)),
                               ("c", scale_decode, lambda: (dm, seed)),
                               ("f", scale_serving, lambda: (dm, seed, out["c"].pop("engines"))),
                               ("d", scale_kernels, None),
                               ("e", scale_training, lambda: (dm, seed, work))):
            t0 = time.perf_counter()
            out[part] = fn(torch, g) if args is None else fn(torch, card, *args())
            walls[part] = round(time.perf_counter() - t0, 1)
    finally:
        dist.destroy_process_group()
    print(f"[scale] phase 17 parts wall s {json.dumps(walls)} | {card}", flush=True)
    rows, launches = out["d"]
    rows.update(out["e"]["rows"])
    launches.update(out["e"]["row_launches"])
    return dict(rows=rows, paths=[out["a"]["launches"], out["b"]["launches"],
                                  *out["c"]["runs"].values(), out["f"]["launches"],
                                  out["f"]["mllama"], out["e"]["launches"]],
                launches=launches, training=out["e"]["launches"])


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

    t_start = time.perf_counter()
    walls = {}

    def run(phase: str, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return out

    card = run("1", phase_device, torch, _build)
    kernels = run("2", phase_kernels, torch, args.seed)
    from multimodal_colpali_tpu_torch.models.registry import (
        GEMMA3_CONFIGS, GEMMA3_MM_CONFIGS, RETRIEVER_CONFIGS)

    (REPO / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="colpali-ckpt-", dir=REPO / "build")
    work = tempfile.mkdtemp(prefix="smoke-", dir=REPO / "build")
    try:
        train = run("16", phase_training, torch, args.seed, card, work)
        # where COLPALI_TPU_CKPT_DIR finds it by the model's name (phase 10's driver)
        ckpt_path = Path(ckpt_dir) / COLPALI.replace("/", "--")
        ckpt_path.mkdir()
        ckpt = write_colpali_checkpoint(torch, RETRIEVER_CONFIGS[COLPALI](), str(ckpt_path),
                                        args.seed)
        colpali, top_pages = run(
            "3", phase_retrieval, torch, COLPALI, args.seed, card, "main",
            device_preprocess=True,
            path=("maxsim", "maxsim.tensor_core", "attention", "attention.tensor_core",
                  "normalize"),
            absent=("vit_layer",),   # SigLIP-So400m is not fused
            link_dir=tempfile.mkdtemp(dir=work), checkpoint=ckpt)
        images = run("7", phase_images, torch, args.seed, card, ckpt, top_pages)
        colsmol = run("4", phase_colsmol, torch, args.seed, card)
        with cut_depth(GEMMA3_CONFIGS, GEN_MODEL, GEN_DEPTH), \
                cut_depth(GEMMA3_MM_CONFIGS, GEN_MODEL, GEN_DEPTH):
            gen = run("5", phase_generation, torch, args.seed, card)
            g3 = run("8", phase_gemma3_images, torch, args.seed, card)
        # ColFlor normalizes on the host; its BART attention has a mask, so no K2
        colflor, _ = run("6", phase_retrieval, torch, "ahmed-masry/ColFlor", args.seed, card,
                         "colflor", device_preprocess=False,
                         path=("window_attention", "window_attention.ring",
                               "maxsim", "maxsim.tensor_core"),
                         absent=("attention", "normalize"),
                         link_dir=tempfile.mkdtemp(dir=work))
        dense = run("9", phase_dense, torch, args.seed, card, work)
        ingest = run("10", phase_ingest, torch, args.seed, card, work, ckpt)
        qwen = run("11", phase_colqwen, torch, args.seed, card, ckpt_path.parent)
        grid = run("13", phase_grid, torch, args.seed, card, work, ckpt)
        old = run("14", phase_old_models, torch, args.seed, card)
        mllama = run("15", phase_mllama, torch, args.seed, card)
        scale = run("17", phase_scaleout, torch, args.seed, card, work)
        experiments = run("12", phase_experiments, torch, args.seed, card, work,
                          ckpt_path.parent)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    print(f"[main] phase wall s {json.dumps(walls)}; {time.perf_counter() - t_start:.1f} s "
          f"in all | {card}", flush=True)

    jax_ops = "multimodal_colpali_tpu/ops"
    meta = {
        "maxsim": ("cuda", f"{PACKAGE}/csrc/maxsim.cu", f"{jax_ops}/maxsim.py:196"),
        "attention": ("cuda", f"{PACKAGE}/csrc/attention.cu", f"{jax_ops}/attention.py:135"),
        # K2's gradient: no pallas_call (the Pallas kernel has no reverse mode);
        # the JAX trainer differentiates the einsum branch
        "attention_backward": ("cuda", f"{PACKAGE}/csrc/attention_backward.cu",
                               "jax.vjp of multimodal_colpali_tpu/models/layers.py:210-231"),
        "normalize": ("cuda", f"{PACKAGE}/csrc/normalize.cu", f"{jax_ops}/preprocess.py:54"),
        "maxsim_int8": ("cuda", f"{PACKAGE}/csrc/maxsim.cu", f"{jax_ops}/maxsim.py:307"),
        "vit_layer": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:367"),
        "attn_block": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu",
                       f"{jax_ops}/fused_layer.py:247"),
        "mlp_block": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:440"),
        # the GEMMs and the statistics pre-pass K5a-c are made of, each a row
        "gemm.qkv": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:247"),
        "gemm.out_proj": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu",
                          f"{jax_ops}/fused_layer.py:247"),
        "gemm.fc1": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:440"),
        "gemm.fc2": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:440"),
        "ln_stats": ("cuda", f"{PACKAGE}/csrc/fused_layer.cu", f"{jax_ops}/fused_layer.py:367"),
        "paged_attention": ("cuda", f"{PACKAGE}/csrc/paged_attention.cu",
                            f"{jax_ops}/paged_attention.py:196"),
        "paged_attention_int8": ("cuda", f"{PACKAGE}/csrc/paged_attention.cu",
                                 f"{jax_ops}/paged_attention.py:350"),
        "int8_matmul_kn": ("cuda", f"{PACKAGE}/csrc/int8_matmul.cu",
                           f"{jax_ops}/int8_matmul.py:145"),
        "int8_matmul_nk": ("cuda", f"{PACKAGE}/csrc/int8_matmul.cu",
                           f"{jax_ops}/int8_matmul.py:179"),
        "window_attention": ("cuda", f"{PACKAGE}/csrc/window_attention.cu",
                             f"{jax_ops}/window_attention.py:79"),
        "int4_matmul_kn": ("cuda", f"{PACKAGE}/csrc/int4_matmul.cu",
                           f"{jax_ops}/int4_matmul.py:134"),
    }
    # each kernel's launches on the main paths that run it; K8a and K9 a row a
    # tile (the decode tile's under the wrapper's name)
    meta["int8_matmul_kn.prefill"] = meta["int8_matmul_kn"]
    meta["int4_matmul_kn.prefill"] = meta["int4_matmul_kn"]
    tile_of = {"int8_matmul_kn": "int8_matmul_kn.decode", "int4_matmul_kn": "int4_matmul_kn.decode"}
    # K2 at the Gemma-3 tower's shape: its launches are phase 8's
    meta["attention.gemma3_tower"] = meta["attention"]
    # K2 at ColQwen2.5's window and full-block shapes: phase 11's launches
    meta["attention.colqwen_window"] = meta["attention"]
    meta["attention.colqwen_full"] = meta["attention"]
    # K2 at ColGranite's tower shape: phase 13 (a)'s square-layout launches
    meta["attention.granite_tower"] = meta["attention"]
    # phase 14's shapes: K2 at Qwen2-VL's and CLIP's towers, K7a / K7b over
    # the speculative verify's B * k rows
    meta["attention.qwen2vl_tower"] = meta["attention"]
    meta["attention.clip_tower"] = meta["attention"]
    meta["paged_attention.verify"] = meta["paged_attention"]
    meta["paged_attention_int8.verify"] = meta["paged_attention_int8"]
    # phase 15's shapes: K7a at Mllama's decode step, K7b over its verify, K8a's
    # prefill tile on the cross K/V rows of 5 images at 2x2
    # phase 16's shape: K2's float32 forward over the training batch's pages
    meta["attention.training"] = meta["attention"]
    meta["paged_attention.mllama_decode"] = meta["paged_attention"]
    meta["paged_attention_int8.mllama_verify"] = meta["paged_attention_int8"]
    meta["int8_matmul_kn.mllama_cross_kv"] = meta["int8_matmul_kn"]
    # phase 17 (d): a rank's shapes at tp = 2 and 4, and a corpus shard; their
    # launches are (d)'s checks at those shapes (no main path runs them on one card)
    for name in scale["launches"]:
        meta[name] = meta[name.split(".")[0]]
    kernels.update(old["rows"])
    kernels.update(mllama["rows"])
    kernels.update(train["rows"])
    kernels.update(scale["rows"])
    paths = [colpali, images["a"], images["b"], colsmol, gen["a"], gen["b"], gen["c"],
             gen["d"], gen["e"], colflor, g3["a"], g3["b"], dense, ingest, qwen["launches"],
             *grid["paths"], *old["paths"], *mllama["paths"], *experiments, train["path"],
             *scale["paths"]]
    shape_rows = ("attention.gemma3_tower", "attention.colqwen_window", "attention.colqwen_full",
                  "attention.granite_tower", *old["launches"], *mllama["launches"],
                  *train["launches"], *scale["launches"])
    launches = {name: sum(p[tile_of.get(name, name)] for p in paths) for name in meta
                if name not in shape_rows}
    launches["attention.gemma3_tower"] = g3["a"]["attention"] + g3["b"]["attention"]
    launches["attention.colqwen_window"] = qwen["attention.colqwen_window"]
    launches["attention.colqwen_full"] = qwen["attention.colqwen_full"]
    launches["attention.granite_tower"] = grid["attention.granite_tower"]
    launches.update(old["launches"])
    launches.update(mllama["launches"])
    launches.update(train["launches"])
    # K2's training rows: phase 16 (a)'s launches and phase 17 (e)'s mesh path's
    launches["attention.training"] += scale["training"]["attention"]
    launches["attention_backward"] += scale["training"]["attention_backward"]
    launches.update(scale["launches"])
    rows = [dict(name=name, route=route, source=src, replaces=rep, launches=launches[name],
                 **kernels[name])
            for name, (route, src, rep) in meta.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
