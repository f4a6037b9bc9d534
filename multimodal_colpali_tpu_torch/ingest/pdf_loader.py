"""PDF -> Document pipeline: the reference's ``pdf_loader``/``data_preparation``
(counterpart of ``multimodal_colpali_tpu/ingest/pdf_loader.py``).

Surface parity with reference functions.py:1336-1355 (pdf_loader) and
functions.py:246-406 (data_preparation): returns ``(docs_multi, docs_text)``
LangChain-shaped Document lists with the exact metadata schema
``{document_name, document_id, document_link, type, page_no, ref, caption,
img_link}`` (functions.py:311-323), and saves page images as
``{vd_dir}/pg_images/{stem}_{page:03d}.png`` (functions.py:269).

The layout/OCR/table models Docling provides (EasyOCR, TableFormer, granite
picture descriptions) are ingestion-time model services, not framework code;
this loader extracts the text layer and page/figure rasters natively
(mmpdf) and exposes hooks (``picture_annotator``, ``ocr_fn``) where those
models plug in. Pages with no text layer are flagged for OCR via
``PdfDocument.has_text`` - the working version of the reference's
``check_ocr`` (functions.py:133-148, which has a ``len(text)>=0`` bug).

Pages, figures and table crops are uint8 arrays here, not PIL images, and
their PNGs are written by ``imageops.write_png``. ``device`` (the card by
default) is where page rasters are resized and where the default OCR's
classifier runs; ``device="cpu"`` keeps everything on the host.
"""

from __future__ import annotations

import uuid
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.documents import Document
from multimodal_colpali_tpu_torch.ingest.chunker import HybridChunker
from multimodal_colpali_tpu_torch.ingest.imageops import crop, write_png
from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image_on
from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument, resized_page


def data_preparation(
    conversion: List[dict],
    vd_dir: str,
    vd_tokenizer,
    mm_dir: str = "",
    only_text: bool = False,
    page_images: bool = True,
    max_chunk_tokens: int = 512,
    picture_annotator=None,
    device: Any = "cuda",
) -> List[Document]:
    """Build Document chunks from parsed PDFs (reference functions.py:246-406).

    ``conversion`` entries: {"filename", "link", "document": PdfDocument,
    optional "picture_annotations": [str]}.
    """
    device = resolve_device(device)
    all_docs: List[Document] = []
    for el in conversion:
        filename = el["filename"]
        filename_link = el.get("link", "")
        document_id = str(uuid.uuid4())
        doc: PdfDocument = el["document"]
        doc_stem = Path(filename).stem

        save_root = Path(vd_dir if mm_dir == "" else mm_dir)
        save_root.mkdir(parents=True, exist_ok=True)

        if page_images:
            pg_dir = save_root / "pg_images"
            pg_dir.mkdir(parents=True, exist_ok=True)
            for page_no in range(1, len(doc) + 1):
                write_png(pg_dir / f"{doc_stem}_{page_no:03d}.png",
                          resized_page(doc, page_no - 1, 144.0, device))

        pages_text = el.get("ocr_text") or [doc.extract_text(i) for i in range(len(doc))]
        chunks = HybridChunker(vd_tokenizer, max_tokens=max_chunk_tokens).chunk_pages(pages_text)
        texts = [
            Document(
                page_content=ch.text,
                metadata={
                    "document_name": doc.name,
                    "document_id": document_id,
                    "document_link": filename_link,
                    "type": "text",
                    "page_no": ch.page_no,
                    "ref": ch.ref,
                    "caption": "",
                    "img_link": "",
                },
            )
            for ch in chunks
        ]

        if only_text:
            all_docs.extend(texts)
            print(f"For {filename} there were {len(texts)} texts processed only_text={only_text}.")
            continue

        # Tables: grid-aligned run blocks -> markdown + caption, the schema
        # of the reference's TableFormer path (functions.py:344-357, emitted
        # as page_content = caption + " " + markdown, img_link = a cropped
        # raster under tables/). Deviation: the table's source runs also
        # remain part of the page text chunks (the reference's chunker
        # excludes table items); noted for parity review.
        tables: List[Document] = []
        tables_dir = save_root / "tables"
        table_counter = 0
        # Layout runs: the native text layer, or - for scanned pages - the
        # OCR's positioned word runs (the TableFormer-on-images role,
        # reference functions.py:85-93: table structure from page IMAGES;
        # round-2 gap: a scanned table produced nothing even after OCR).
        ocr_runs = el.get("ocr_runs")
        if hasattr(doc, "extract_runs") or ocr_runs:
            from multimodal_colpali_tpu_torch.ingest.tables import detect_tables

            for page_no in range(1, len(doc) + 1):
                if ocr_runs is not None:
                    page_runs = (ocr_runs[page_no - 1]
                                 if page_no <= len(ocr_runs) else [])
                    # OCR word x positions jitter by a couple of px
                    dets = detect_tables(page_runs, x_tol=5.0)
                else:
                    page_rules = (doc.extract_rules(page_no - 1)
                                  if hasattr(doc, "extract_rules") else None)
                    dets = detect_tables(doc.extract_runs(page_no - 1),
                                         rules=page_rules)
                for det in dets:
                    table_counter += 1
                    if table_counter == 1:
                        tables_dir.mkdir(parents=True, exist_ok=True)
                    link = tables_dir / f"{doc_stem}_table_{table_counter:03d}.png"
                    try:
                        page_img = doc.render(page_no - 1, dpi=144.0)
                        x0, y0, x1, y1 = det.bbox
                        write_png(link, crop(page_img, (
                            max(int(x0 * 2) - 4, 0), max(int(y0 * 2) - 4, 0),
                            min(int(x1 * 2) + 4, page_img.shape[1]),
                            min(int(y1 * 2) + 4, page_img.shape[0]))))
                    except Exception:  # noqa: BLE001 - crop is best-effort
                        link = ""
                    md = det.to_markdown()
                    tables.append(Document(
                        page_content=(det.caption + " " + md) if det.caption else md,
                        metadata={
                            "document_name": doc.name,
                            "document_id": document_id,
                            "document_link": filename_link,
                            "type": "table",
                            "page_no": page_no,
                            "ref": f"#/tables/{table_counter - 1}",
                            "caption": det.caption,
                            "img_link": str(link),
                        },
                    ))

        # Figures: embedded raster images extracted natively by mmpdf, saved
        # as images/{stem}_img_{idx:03d}.png (reference functions.py:292-297).
        # VLM descriptions are filled in later by process_models (the
        # reference's flow); table structure still needs a layout model and
        # arrives through the picture_annotations hook.
        pictures: List[Document] = []
        figure_images: List[Any] = []
        images_dir = save_root / "images"
        picture_counter = 0
        if hasattr(doc, "extract_images"):
            for page_no in range(1, len(doc) + 1):
                for img, _bbox in doc.extract_images(page_no - 1):
                    if min(img.shape[:2]) < 16:
                        continue  # decorative strips/icons
                    picture_counter += 1
                    if picture_counter == 1:
                        images_dir.mkdir(parents=True, exist_ok=True)
                    link = images_dir / f"{doc_stem}_img_{picture_counter:03d}.png"
                    write_png(link, resize_image_on(img, device))
                    figure_images.append(img)
                    pictures.append(Document(
                        page_content="",
                        metadata={
                            "document_name": doc.name,
                            "document_id": document_id,
                            "document_link": filename_link,
                            "type": "image",
                            "page_no": page_no,
                            "ref": f"#/pictures/{picture_counter - 1}",
                            "caption": "",
                            "img_link": str(link),
                        },
                    ))
        # In-converter VLM descriptions (the reference's granite flow,
        # functions.py:93-99): annotate extracted figures at parse time so
        # image documents carry text before indexing.
        if picture_annotator is not None and figure_images:
            descriptions = picture_annotator(figure_images)
            for pic_doc, desc in zip(pictures, descriptions):
                cap = pic_doc.metadata.get("caption", "")
                pic_doc.page_content = (cap + str(desc)) if cap else str(desc)

        for ann in el.get("picture_annotations", []):
            picture_counter += 1
            pictures.append(Document(
                page_content=ann.get("text", "") if isinstance(ann, dict) else str(ann),
                metadata={
                    "document_name": doc.name,
                    "document_id": document_id,
                    "document_link": filename_link,
                    "type": "image",
                    "page_no": int(ann.get("page_no", 1)) if isinstance(ann, dict) else 1,
                    "ref": f"#/pictures/{picture_counter - 1}",
                    "caption": ann.get("caption", "") if isinstance(ann, dict) else "",
                    "img_link": ann.get("img_link", "") if isinstance(ann, dict) else "",
                },
            ))

        all_docs.extend(texts + tables + pictures)
        print(
            f"For {filename} there were {len(texts)} texts, {len(tables)} tables "
            f"and {len(pictures)} images processed, equals "
            f"{len(texts) + len(tables) + len(pictures)} documents."
        )

    print(f"Total number of elements processed: {len(all_docs)}.")
    return all_docs


def check_ocr(paper: str) -> bool:
    """True if the PDF's first page has no text layer (needs OCR).

    Implements the *intended* semantics of reference functions.py:133-148.
    """
    try:
        return not PdfDocument(paper).has_text(0)
    except ValueError:
        return True


def pdf_loader(
    papers: Sequence[str],
    doi_links: Sequence[str],
    filenames: Sequence[str],
    vd_dir: str,
    vd_tokenizer,
    ocr_fn: Optional[Callable[[str], List[str]]] = None,
    picture_annotator: Optional[Callable[[Sequence[Any]], List[str]]] = None,
    device: Any = "cuda",
) -> Tuple[List[Document], List[Document]]:
    """Parse PDFs twice (multi + text-only), reference functions.py:1336-1355.

    Returns ``(docs_multi, docs_text)``. ``ocr_fn(path) -> [page_texts]``
    runs when ``check_ocr`` fires (scanned/image-only PDF); by default the
    built-in template OCR (ingest/ocr.py) recovers machine-printed text, the
    role EasyOCR plays inside the reference's Docling converter
    (functions.py:78-80). Pass a custom ``ocr_fn`` to plug in another model.
    The default OCR's classifier and the page resizes run on ``device``.
    """
    device = resolve_device(device)
    conversion = []
    for paper, link, fname in zip(papers, doi_links, filenames):
        doc = PdfDocument(paper)
        el = {"filename": fname, "link": link, "document": doc}
        if check_ocr(paper):
            if ocr_fn is None:
                from multimodal_colpali_tpu_torch.ingest.ocr_conv import AutoOcr

                ocr_fn = AutoOcr(device=device)
            print(f"{fname} has no text layer; running OCR")
            if hasattr(ocr_fn, "pdf_text_and_runs"):
                el["ocr_text"], el["ocr_runs"] = \
                    ocr_fn.pdf_text_and_runs(paper)
            else:
                el["ocr_text"] = ocr_fn(paper)
        conversion.append(el)

    docs_multi = data_preparation(conversion, vd_dir, vd_tokenizer,
                                  picture_annotator=picture_annotator, device=device)
    docs_text = data_preparation(conversion, vd_dir, vd_tokenizer,
                                 only_text=True, page_images=False, device=device)
    return docs_multi, docs_text
