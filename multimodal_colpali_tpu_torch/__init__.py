"""PyTorch + CUDA port of ``multimodal_colpali_tpu``: the retrieval paths, the
dense RAG modes and the generation tier.

The JAX package beside this one is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``store/``, ``generation/``, ``api.py``) so each
module's counterpart is found under the same name. It imports ``torch`` and
never JAX, Flax or the JAX package.

Ported:

- the ColPali, ColIdefics3 (ColSmol) and ColFlor retrievers, from HF
  checkpoints (``models/hf_import``) or seeded random weights;
- the multivector store in its exact, int8, pooled and on_disk modes, the
  dense store (``store/dense``) and the client over both;
- the bge-base text encoder (``models/bert``, ``models/text_encoder``) and
  the reference-shaped API (``api.py``): ColPali indexing and search, the
  dense collections, the prompt functions of the no-RAG, mm_RAG and colpali
  modes, the multi-user management; the message formatters and the answer
  parser (``generation/{messages,parse}``), ``documents`` and ``prompts``;
- the generation tier for the Gemma-1/Gemma-3 text LMs and their image
  engines (``generation/``: decode engine, ``PaliGemmaEngine``,
  ``Gemma3MMEngine``, dense and paged continuous batchers, OpenAI server;
  ``serve.py``);
- the experiment's client and statistics: the OpenAI client
  (``generation/client``, on the standard library), ``config``,
  ``utils/{health,housekeeping,io,userops}``, ``evalstats`` and the
  evaluation drivers 02a, 04 and 06 (``drivers/``). ``evalstats``,
  ``utils/io`` and ``drivers`` need pandas, which the GPU host lacks; no
  serving or retrieval module imports them.

Every TPU kernel has a hand-written CUDA C++ counterpart (``csrc/``, built
for ``sm_90a``) beside a plain PyTorch version:

- K1 MaxSim and K4 int8 MaxSim (``csrc/maxsim.cu``, ``ops/maxsim.py``)
- K2 attention (``csrc/attention.cu``, ``ops/attention.py``)
- K3 uint8 normalize (``csrc/normalize.cu``, ``ops/preprocess.py``)
- K5a-c fused SigLIP layer, attention block and MLP block (GEMMs in
  ``csrc/fused_layer.cu`` with K2, ``ops/fused_layer.py``)
- K6 DaViT window attention (``csrc/window_attention.cu``,
  ``ops/window_attention.py``)
- K7a/K7b paged decode attention over bf16 / int8 pools
  (``csrc/paged_attention.cu``, ``ops/paged_attention.py``)
- K8a/K8b int8-weight products for the projections / the tied LM head
  (``csrc/int8_matmul.cu``, ``ops/int8_matmul.py``)
- K9 group-wise int4-weight products (``csrc/int4_matmul.cu``,
  ``ops/int4_matmul.py``; K8a's and K9's prefill tile in ``csrc/wstream.cuh``)

The dense path runs none of them: BERT's attention has a key-padding mask
and takes the plain einsum, as in JAX, and the dense search is one product
and a stable sort.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
the call raises. Entry points run on the GPU unless given ``device="cpu"``.
The CUDA kernels are compiled with nvcc for ``sm_90a`` into
``build/kernels`` at first use (``_build.py``).
"""
