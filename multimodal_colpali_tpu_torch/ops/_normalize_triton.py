"""K3: fused rescale + normalize of uint8 pixels, in Triton.

Replaces the TPU kernel multimodal_colpali_tpu/ops/preprocess.py::_normalize_kernel
(pl.pallas_call at preprocess.py:54, wrapper normalize_images).

This module imports ``triton`` at its top, so only the launcher
(``ops/preprocess.normalize_images_triton``) imports it, inside the call.

What bounds it on an H100: nothing but device memory. Each element is one
byte in and two bytes out with one multiply-add between, no reuse and no
tensor-core work, so the kernel is a flat elementwise pass: each program
loads a contiguous block of bytes (coalesced), widens them to float32,
takes the channel as ``index % 3`` of the NHWC layout, applies that
channel's scale and bias, and stores bf16.
"""

import triton
import triton.language as tl


@triton.jit
def normalize_kernel(x_ptr, out_ptr, n, s0, s1, s2, b0, b1, b2,
                     BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    live = offs < n
    x = tl.load(x_ptr + offs, mask=live, other=0).to(tl.float32)
    c = offs % 3
    scale = tl.where(c == 0, s0, tl.where(c == 1, s1, s2))
    bias = tl.where(c == 0, b0, tl.where(c == 1, b1, b2))
    tl.store(out_ptr + offs, (x * scale + bias).to(tl.bfloat16), mask=live)
