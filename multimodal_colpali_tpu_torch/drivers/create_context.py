"""Ingest & index: build the text, multimodal and ColPali collections from PDFs.

Counterpart of ``drivers/01_create_context.py`` (CLI-compatible with the
reference's 01_create_context_qdrant.py, args at :100-110, flow at
:232-305), with the same flags:

    python -m multimodal_colpali_tpu_torch.drivers.create_context \\
        --papers-dir papers --vd-dir vd --skip-summaries

``pdf_loader`` -> per-model VLM image summaries (skipped with
``--skip-summaries``) -> dense text + multimodal collections (bge-base) ->
page PNGs -> per-model ColPali multivector collections, all persisted under
``--vd-dir`` by ``VectorClient``. ``--device`` (the card by default) is
where the encoders run and where the pages are resized; ``--device cpu``
runs everything on the host. The page PNGs are read back with
``imageops.read_png`` (the JAX driver opens them with Pillow), so the
dataset holds uint8 arrays. The wall time of each stage is printed at the
end as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional

from multimodal_colpali_tpu_torch import api
from multimodal_colpali_tpu_torch.config import EMBED_MODEL_ID, load_models_config
from multimodal_colpali_tpu_torch.generation.client import run_sync
from multimodal_colpali_tpu_torch.ingest import convert_pdfs_to_images, pdf_loader
from multimodal_colpali_tpu_torch.ingest.imageops import read_png
from multimodal_colpali_tpu_torch.models import load_retriever
from multimodal_colpali_tpu_torch.models.configs import BertConfig
from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings
from multimodal_colpali_tpu_torch.store import VectorClient

DEFAULT_PROMPT = {
    "img_summary": (
        "Describe the scientific figure in detail, focusing on the biological "
        "entities, axes, and relationships shown."
    ),
    "text_summary": "Summarize the following passage faithfully and concisely: ",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Create Experiment 01 context collections.")
    p.add_argument("--papers-dir", default=os.environ.get("PAPERS_DIR", "./papers"))
    p.add_argument("--vd-dir", default=os.environ.get("VD_DIR", "./src/vectordb"))
    p.add_argument("--prompts-path", default="prompts_used.pkl")
    p.add_argument("--models-config", default=None)
    p.add_argument("--doi-file", default=None)
    p.add_argument("--device", default="cuda",
                   help="Where the encoders run and pages are resized (cuda or cpu).")
    p.add_argument("--skip-summaries", action="store_true",
                   help="Skip the VLM image-summary stage (no generation endpoint).")
    p.add_argument("--base-url", default=os.environ.get("OPENAI_BASE_URL"))
    p.add_argument("--dpi", type=float, default=144.0)
    p.add_argument("--dynamic-resolution", action="store_true",
                   help="Per-image resolution layouts (not ported: raises).")
    p.add_argument("--text-encoder-config", default="bge-base",
                   choices=["bge-base", "tiny"])
    return p.parse_args(argv)


def list_papers(papers_dir: Path):
    if not papers_dir.exists():
        raise FileNotFoundError(f"Papers directory not found: {papers_dir}")
    return sorted(p for p in papers_dir.iterdir() if p.suffix.lower() == ".pdf")


def read_doi_file(path, num_papers):
    if path is None:
        return [""] * num_papers
    with open(path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) != num_papers:
        raise ValueError(f"DOI file contains {len(lines)} entries, but {num_papers} PDFs were found.")
    return lines


def load_prompts(path):
    if path and Path(path).exists():
        with open(path, "rb") as fh:
            return pickle.load(fh)
    return DEFAULT_PROMPT


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the driver -> the wall seconds of each stage."""
    args = parse_args(argv)
    stages: Dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        stages[name] = now - t0
        t0 = now

    papers_dir = Path(args.papers_dir)
    vd_dir = Path(args.vd_dir)
    vd_dir.mkdir(parents=True, exist_ok=True)

    papers = list_papers(papers_dir)
    doi_links = read_doi_file(args.doi_file, len(papers))
    prompts = load_prompts(args.prompts_path)
    models_cfg = load_models_config(args.models_config)

    if args.text_encoder_config == "tiny":
        embeddings = BgeEmbeddings(cfg=BertConfig.tiny(), device=args.device)
    else:
        embeddings = BgeEmbeddings(model_name=EMBED_MODEL_ID, device=args.device)
    tokenizer = embeddings.tokenizer
    lap("text_encoder")

    processed_multi, processed_text = pdf_loader(
        papers=[str(p) for p in papers],
        doi_links=doi_links,
        filenames=[p.name for p in papers],
        vd_dir=str(vd_dir),
        vd_tokenizer=tokenizer,
        device=args.device,
    )
    lap("pdf_loader")

    if args.skip_summaries:
        model_outputs = {m["model_short"]: processed_multi for m in models_cfg}
    else:
        model_outputs = run_sync(api.process_models(
            processed_multi, prompts, models_cfg, base_url=args.base_url))
    model_outputs["text_only"] = processed_text
    lap("summaries")

    client = VectorClient(path=str(vd_dir / "storage"), device=args.device)

    emb_dim = embeddings.cfg.hidden_size  # EMB_DIM (768) for bge-base
    text_loaded = False
    for model_cfg in models_cfg:
        if not text_loaded:
            api.qdrant_process(model_outputs["text_only"], client,
                               model_cfg["text_vd"], emb_dim, embeddings)
            text_loaded = True
        api.qdrant_process(model_outputs[model_cfg["model_short"]], client,
                           model_cfg["mm_vd"], emb_dim, embeddings)
    lap("dense_collections")

    # Page rasters + ColPali collections.
    saved = convert_pdfs_to_images([str(p) for p in papers], str(vd_dir), dpi=args.dpi,
                                   device=args.device)
    dataset = []
    for paper in papers:
        for page_no, png in enumerate(saved[paper.stem], start=1):
            dataset.append({
                "image": read_png(png),
                "filename": paper.name,
                "page_no": page_no,
                "img_link": png,
            })
    lap("page_pngs")

    for model_cfg in models_cfg:
        retriever = load_retriever(model_cfg["late_inter"], device=args.device,
                                   dynamic_resolution=args.dynamic_resolution)
        cfg = retriever.model.cfg
        # the page-sequence length from the processor (dynamic layouts are
        # refused by load_retriever above)
        probe = retriever.processor.process_images([dataset[0]["image"]],
                                                   device=retriever.device)
        seq_len = int(probe["input_ids"].shape[1])
        api.ensure_colpali_collection(
            client, model_cfg["late_inter_short"],
            vector_size=cfg.embedding_dim,
            max_tokens=((seq_len + 7) // 8) * 8,
        )
        api.colpali_qdrant(
            dataset, [str(p) for p in papers], doi_links,
            retriever, retriever.processor, client,
            model_cfg["late_inter_short"],
        )
        del retriever
    lap("colpali_collections")

    client.save()
    lap("save")
    print(f"[01] stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    print("[done] Context creation completed.")
    return stages


if __name__ == "__main__":
    main()
