"""PyTorch + CUDA port of the ColPali retrieval path of ``multimodal_colpali_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``store/``, ``api.py``) so each module's
counterpart is found under the same name. It imports ``torch`` and never
JAX, Flax or the JAX package.

Kernels on the retrieval path, each beside a plain PyTorch version:

- K1 MaxSim (CUDA C++, ``csrc/maxsim.cu``, ``ops/maxsim.py``)
- K2 attention (CUDA C++, ``csrc/attention.cu``, ``ops/attention.py``)
- K3 uint8 normalize (Triton, ``ops/_normalize_triton.py``, ``ops/preprocess.py``)

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
the call raises. The CUDA kernels are compiled with nvcc for ``sm_90a`` into
``build/kernels`` at first use (``_build.py``).
"""
