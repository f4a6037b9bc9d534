"""PDF ingest (counterpart of ``multimodal_colpali_tpu/ingest``): the native
mmpdf rasterizer and text layer, Pillow-exact image operations
(``imageops``), chunking, tables, OCR, the ``pdf_loader`` documents and the
pipelined corpus embedder. Pages are uint8 arrays (tensors on a CUDA
device), not PIL images."""

from multimodal_colpali_tpu_torch.ingest.chunker import Chunk, HybridChunker  # noqa: F401
from multimodal_colpali_tpu_torch.ingest.pdf_loader import (  # noqa: F401
    check_ocr,
    data_preparation,
    pdf_loader,
)
from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image  # noqa: F401
from multimodal_colpali_tpu_torch.ingest.rasterize import (  # noqa: F401
    PdfDocument,
    convert_pdf_dir_to_images,
    convert_pdfs_to_images,
)
