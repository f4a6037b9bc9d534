"""PyTorch + CUDA port of ``multimodal_colpali_tpu``: the retrieval path and
the text generation tier.

The JAX package beside this one is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``store/``, ``api.py``) so each module's
counterpart is found under the same name. It imports ``torch`` and never
JAX, Flax or the JAX package.

Ported: the ColPali and ColIdefics3 (ColSmol) retrievers, the multivector
store in its exact, int8, pooled and on_disk modes, the retrieval API, and
the generation tier for the Gemma-1/Gemma-3 text LMs (``generation/``: decode
engine, dense and paged continuous batchers, OpenAI server; ``serve.py``).
Kernels on those paths, each beside a plain PyTorch version:

- K1 MaxSim (CUDA C++, ``csrc/maxsim.cu``, ``ops/maxsim.py``)
- K2 attention (CUDA C++, ``csrc/attention.cu``, ``ops/attention.py``)
- K3 uint8 normalize (Triton, ``ops/_normalize_triton.py``, ``ops/preprocess.py``)
- K4 int8 MaxSim (CUDA C++, ``csrc/maxsim.cu``, ``ops/maxsim.py``)
- K5a-c fused SigLIP layer, attention block and MLP block (CUDA C++ GEMMs in
  ``csrc/fused_layer.cu`` with K2, ``ops/fused_layer.py``)
- K7a/K7b paged decode attention over bf16 / int8 pools (CUDA C++,
  ``csrc/paged_attention.cu``, ``ops/paged_attention.py``)
- K8a/K8b int8-weight products for the projections / the tied LM head (CUDA
  C++, ``csrc/int8_matmul.cu``, ``ops/int8_matmul.py``)

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
the call raises. Entry points run on the GPU unless given ``device="cpu"``. The CUDA kernels are compiled with nvcc for ``sm_90a`` into
``build/kernels`` at first use (``_build.py``).
"""
