"""Experiment 01: one evaluation run (one model x one RAG mode).

Counterpart of ``drivers/02_experiment01.py`` (reference
02_experiment01.py:58-344), with its flags and its artifact: the pickle
``{model, evaluation, elapsed_time, timestamp, permuted_answers}`` named
``{filepath_output}_{timestamp}[_perm_q].pkl``, which the evaluation driver
(``experiment01_eval``) reads:

    python -m multimodal_colpali_tpu_torch.drivers.experiment01 --vllm_port 8006 \\
        --model_name gpt-5 --filepath_output results/eval/run --type colpali \\
        --vector_db colpali_db --storage-path vd --qa_path questions.csv

Retrieval runs on the port: ``colpali`` through ``load_retriever`` and
``api.retrieve_colpali`` (the retriever on ``--device``, the card by
default), ``mm_RAG`` through ``BgeEmbeddings`` and ``api.TpuVectorStore``.
Requests go through the port's standard-library ``ClientSession`` (256
connections, 4 tries, 120 s each, backoff 1, 2, 4 s). The question table is
read and shuffled without pandas (``drivers/_table.py``), the page images
become PNG data URLs without Pillow (``generation/messages.py``), and the
timestamp is CET by ``zoneinfo`` (the EU summer-time rule where the machine
has no time-zone data).
"""

from __future__ import annotations

import argparse
import asyncio
import datetime
import os
import pickle
import random
from pathlib import Path
from time import time
from typing import Any, Dict, List, Optional

from multimodal_colpali_tpu_torch.drivers._table import Table, read_table
from multimodal_colpali_tpu_torch.generation.client import (
    ClientSession, mcq_response_format, resolve_endpoint, run_sync)
from multimodal_colpali_tpu_torch.generation.messages import (
    build_instruction_block, build_reference_from_metadata, document_to_context_entry,
    encode_image_to_data_url)
from multimodal_colpali_tpu_torch.generation.parse import response_real_out

DEFAULT_TOP_K = 5
BENCHMARK_PATH = Path("./data/Glycans_q_a_v5.xlsx")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Run Experiment 01 evaluation for a single model/RAG mode.")
    parser.add_argument("--vllm_port", type=int, required=True,
                        help="Port of the vLLM server (ignored for GPT models).")
    parser.add_argument("--model_name", required=True, help="Model identifier.")
    parser.add_argument("--filepath_output", required=True,
                        help="Prefix for the pickle output (timestamp appended).")
    parser.add_argument("--vector_db", default="",
                        help="Collection used for retrieval (if applicable).")
    parser.add_argument("--type", default="", choices=["", "mm_RAG", "colpali"],
                        help="Retrieval type: '' (no RAG), 'mm_RAG', or 'colpali'.")
    parser.add_argument("--perm_quest", default="No",
                        help="Set to 'Yes' to permute answer order per question.")
    parser.add_argument("--top_k", type=int, default=DEFAULT_TOP_K)
    parser.add_argument("--qa_path", default=str(BENCHMARK_PATH))
    parser.add_argument("--storage-path", default=os.environ.get("VD_DIR", "./src/vectordb"),
                        help="VectorClient persistence directory.")
    parser.add_argument("--retriever", default="vidore/colpali-v1.3-hf",
                        help="Late-interaction retriever checkpoint name.")
    parser.add_argument("--base-url", default=os.environ.get("OPENAI_BASE_URL"),
                        help="Override generation endpoint (e.g. a local fake).")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed question shuffling/permutations (reference is unseeded).")
    parser.add_argument("--dynamic-resolution", action="store_true",
                        help="Per-image resolution layouts for supported families.")
    parser.add_argument("--text-encoder-config", default="bge-base",
                        choices=["bge-base", "tiny"],
                        help="Dense text encoder size for mm_RAG/text_RAG mode.")
    parser.add_argument("--device", default="cuda",
                        help="Where the encoders run (cuda or cpu).")
    return parser.parse_args(argv)


def load_questions(path: Path, seed=None) -> Table:
    return read_table(str(path)).sample(seed)


def should_permute(flag: str) -> bool:
    return flag.lower() in {"yes", "true", "1"}


class RetrievalManager:
    """Retrieval for the Experiment-01 RAG modes (reference 02:93-165)."""

    def __init__(self, retrieval_type: str, vector_db: str, top_k: int,
                 storage_path: str, retriever_name: str,
                 text_encoder_config: str = "bge-base",
                 dynamic_resolution: bool = False, device: Any = "cuda"):
        self.retrieval_type = retrieval_type
        self.device = device
        self.vector_db = vector_db
        self.top_k = top_k
        self.client = None
        self.vector_store = None
        self.colpali = None
        if retrieval_type and vector_db:
            from multimodal_colpali_tpu_torch.store import VectorClient

            self.client = VectorClient(path=storage_path, device=device)
        if retrieval_type == "mm_RAG" and vector_db:
            from multimodal_colpali_tpu_torch import api
            from multimodal_colpali_tpu_torch.models.configs import BertConfig
            from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings

            emb = (BgeEmbeddings(cfg=BertConfig.tiny(), device=device)
                   if text_encoder_config == "tiny" else BgeEmbeddings(device=device))
            self.vector_store = api.TpuVectorStore(self.client, vector_db, emb)
        elif retrieval_type == "colpali" and vector_db:
            from multimodal_colpali_tpu_torch.models import load_retriever

            self.colpali = load_retriever(retriever_name, device=device,
                                          dynamic_resolution=dynamic_resolution)

    def fetch(self, query: str) -> List[Dict[str, Any]]:
        if self.retrieval_type == "" or self.top_k <= 0:
            return []
        if self.retrieval_type == "mm_RAG" and self.vector_store is not None:
            docs = self.vector_store.similarity_search_with_score(query, self.top_k)
            return [document_to_context_entry(doc, score) for doc, score in docs]
        if self.retrieval_type == "colpali" and self.colpali is not None:
            from multimodal_colpali_tpu_torch import api

            result = api.retrieve_colpali(query, self.colpali.processor, self.colpali,
                                          self.client, "", self.vector_db, self.top_k)
            entries = []
            for point in result.points:
                payload = point.payload or {}
                metadata = payload.get("metadata", payload)
                entries.append({
                    "type": "image",
                    "text": "",
                    "image_path": metadata.get("img_link"),
                    "reference": build_reference_from_metadata(metadata),
                    "score": point.score,
                })
            return entries
        return []


def build_messages(question: str, answers, contexts, device: Any = None):
    """Prompt assembly + reference labels (reference 02:168-188); page images
    are resized on ``device`` where it is a CUDA one."""
    instruction = build_instruction_block(question, answers)
    content = [{"type": "text", "text": instruction}]
    references = []
    for ctx in contexts:
        reference = ctx.get("reference", "context")
        if ctx.get("image_path") and ctx["type"] == "image":
            data_url = encode_image_to_data_url(ctx["image_path"], device=device)
            if data_url:
                content.append({"type": "image_url", "image_url": {"url": data_url}})
                references.append(reference)
        if ctx.get("text"):
            snippet = ctx["text"].strip()
            if snippet:
                content.append({"type": "text", "text": f"[{reference}] {snippet}"})
                if reference not in references:
                    references.append(reference)
    return [{"role": "user", "content": content}], references


def prepare_requests(qa_table: Table, retrieval: RetrievalManager, permute_answers: bool,
                     rng: random.Random):
    messages_list, records = [], []
    for row in qa_table.rows():
        answers = [row["A"], row["B"], row["C"], row["D"]]
        perm_idx = rng.sample(range(4), 4) if permute_answers else list(range(4))
        shuffled = [answers[i] for i in perm_idx]
        contexts = retrieval.fetch(row["question"])
        messages, refs = build_messages(row["question"], shuffled, contexts, retrieval.device)
        messages_list.append(messages)
        records.append({
            "Question_nr": row["Question_nr"],
            "question": row["question"],
            "quest_order": perm_idx,
            "context_refs": refs,
        })
    return messages_list, records


async def run_inference_raw(model_name, messages_list, url, headers, use_schema):
    payloads = []
    for messages in messages_list:
        body = {"model": model_name, "messages": messages}
        if use_schema:
            body["response_format"] = mcq_response_format()
        payloads.append(body)
    async with ClientSession(limit=256) as session:
        return await asyncio.gather(*[
            _json_request(session, url, headers, body) for body in payloads])


async def _json_request(session, url, headers, body, retries=4, backoff=1.0):
    for attempt in range(retries):
        try:
            r = await session.post(url, headers, body, timeout=120)
            if r.status == 200:
                return r.json()
            raise RuntimeError(f"HTTP {r.status}: {r.body.decode('utf-8', 'replace')}")
        except Exception:
            if attempt < retries - 1:
                await asyncio.sleep(backoff * (2 ** attempt))
            else:
                raise


def extract_answer_text(response_payload: dict) -> str:
    choices = response_payload.get("choices", [])
    if not choices:
        return ""
    content = choices[0].get("message", {}).get("content")
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content if isinstance(p, dict))
    return ""


def _last_sunday(year: int, month: int) -> datetime.date:
    d = datetime.date(year, month + 1, 1) - datetime.timedelta(days=1)
    return d - datetime.timedelta(days=(d.weekday() + 1) % 7)


def cet_time(utc: datetime.datetime, tzdata: bool = True) -> datetime.datetime:
    """An aware UTC time in CET/CEST (``pd.Timestamp("now", tz="CET")``'s
    zone): ``zoneinfo``'s "CET", or with ``tzdata=False`` or where the
    machine has no time-zone data, the EU rule (UTC+2 from 01:00 UTC on the
    last Sunday of March to 01:00 UTC on the last Sunday of October, else
    UTC+1)."""
    if tzdata:
        try:
            from zoneinfo import ZoneInfo

            return utc.astimezone(ZoneInfo("CET"))
        except Exception:  # noqa: BLE001 - ZoneInfoNotFoundError, or no tzdata module
            pass
    start = datetime.datetime.combine(_last_sunday(utc.year, 3), datetime.time(1),
                                      datetime.timezone.utc)
    end = datetime.datetime.combine(_last_sunday(utc.year, 10), datetime.time(1),
                                    datetime.timezone.utc)
    hours = 2 if start <= utc < end else 1
    return utc.astimezone(datetime.timezone(datetime.timedelta(hours=hours)))


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    rng = random.Random(args.seed)
    qa_table = load_questions(Path(args.qa_path), seed=args.seed)
    permute_answers = should_permute(args.perm_quest)
    retrieval = RetrievalManager(args.type, args.vector_db, args.top_k, args.storage_path,
                                 args.retriever, text_encoder_config=args.text_encoder_config,
                                 dynamic_resolution=args.dynamic_resolution, device=args.device)
    messages_list, records = prepare_requests(qa_table, retrieval, permute_answers, rng)

    if args.base_url:
        url, headers = resolve_endpoint(args.model_name, args.vllm_port, args.base_url)
        use_schema = args.model_name.startswith("gpt")
    elif args.model_name.startswith("gpt"):
        url = "https://api.openai.com/v1/chat/completions"
        headers = {"Authorization": f"Bearer {os.environ['OPENAI_API_KEY']}",
                   "Content-Type": "application/json"}
        use_schema = True
    else:
        url = f"http://localhost:{args.vllm_port}/v1/chat/completions"
        headers = {"Authorization": f"Bearer {os.environ.get('VLLM_API_KEY', 'EMPTY')}",
                   "Content-Type": "application/json"}
        use_schema = False

    t_start = time()
    responses = run_sync(run_inference_raw(args.model_name, messages_list, url, headers,
                                           use_schema))
    out_list = []
    for record, raw in zip(records, responses):
        parsed = extract_answer_text(raw)
        filt_resp, answer_letter = response_real_out(parsed, record["quest_order"])
        out_list.append({**record, "answer": answer_letter, "resp_init": (parsed or "")[:50],
                         "filt_resp": filt_resp})

    timestamp = cet_time(datetime.datetime.now(datetime.timezone.utc)).strftime("%Y%m%d-%H%M%S")
    suffix = "_perm_q" if permute_answers else ""
    eval_results = {
        "model": args.model_name,
        "evaluation": sorted(out_list, key=lambda x: x["Question_nr"]),
        "elapsed_time": time() - t_start,
        "timestamp": timestamp,
        "permuted_answers": permute_answers,
    }
    output_path = Path(f"{args.filepath_output}_{timestamp}{suffix}.pkl")
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with output_path.open("wb") as fh:
        pickle.dump(eval_results, fh)
    print(f"Saved evaluation results to {output_path}")


if __name__ == "__main__":
    main()
