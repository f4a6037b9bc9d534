"""Experiment 02: generator x visual-retriever grid with in-memory MaxSim.

Counterpart of ``drivers/05_experiment02.py`` (reference
05_experiment02.py:53-470), with its flags and artifacts: the embedding
cache ``{cache_dir}/{retriever}_pdf_emb[_dynres].pkl`` (float32 numpy
embeddings, readable by both packages) and one CSV an iteration,
``eval_{ret}_{model}_{ts}[_k].csv``, with the question table's columns and
``Model, Model_ret, Answer, Context_papers, Cor_answer``, which
``experiment02_eval`` reads:

    python -m multimodal_colpali_tpu_torch.drivers.experiment02 --pdf_dir papers \\
        --retrievers vidore/colqwen2.5-v0.2 vidore/colpali-v1.3 --context --models gpt-5

Pages are embedded by ``PipelinedEmbedder(retriever, batch_size=32)`` and
rasterized by ``convert_pdf_dir_to_images`` on ``--device`` (the card by
default: the pages stay CUDA tensors); ``api.score_results`` ranks them
(K1) and the retrieved pages become JPEG data URLs at width 1,024 through
the port's encoder (Pillow's bytes, no Pillow). Requests go through the
port's ``ClientSession`` (64 connections, 5 tries, 180 s each, a 429
retried after 2^attempt s). The question table is read, shuffled and the
results written without pandas (``drivers/_table.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import pickle
from pathlib import Path
from time import gmtime, strftime
from typing import Any, Iterable, List, Optional, Tuple

from multimodal_colpali_tpu_torch.drivers._table import Table, read_table
from multimodal_colpali_tpu_torch.generation.client import (
    ClientSession, mcq_response_format, resolve_endpoint, run_sync)
from multimodal_colpali_tpu_torch.generation.messages import (
    image_context_messages as _image_parts)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run Experiment 02 multi-modal evaluations.")
    p.add_argument("--qa_path", default="./data/Glycans_q_a_v5.xlsx")
    p.add_argument("--pdf_dir", default="papers_merge")
    p.add_argument("--results_dir", default="results/evals")
    p.add_argument("--cache_dir", default="data")
    p.add_argument("--models", nargs="+", default=["gpt-5", "gpt-5-mini", "gpt-5-nano"])
    p.add_argument("--retrievers", nargs="+", default=["vidore/colpali-v1.3-merged"])
    p.add_argument("--iterations", type=int, default=5)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--chunk", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="Where the retrievers run and the pages are resized (cuda or cpu).")
    p.add_argument("--context", action="store_true",
                   help="If set, enable retrieval-augmented prompting.")
    p.add_argument("--base-url", default=os.environ.get("OPENAI_BASE_URL"))
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dynamic-resolution", action="store_true",
                   help="Per-image resolution layouts for supported families.")
    return p.parse_args(argv)


def batched(iterable: List[str], n: int) -> Iterable[List[str]]:
    for idx in range(0, len(iterable), n):
        yield iterable[idx: idx + n]


def build_query_prompts(table_qa: Table) -> Tuple[List[str], List[str]]:
    """Retrieval + generation prompts (reference 05:175-197)."""
    prompts_for_retrieval, prompts_for_model = [], []
    resp_labels = ["A", "B", "C", "D"]
    for row in table_qa.rows():
        answers = [row["A"], row["B"], row["C"], row["D"]]
        question_string = "".join(
            f"{label}. {option}" for label, option in zip(resp_labels, answers))
        base_prompt = (
            f"You are an experienced senior researcher tasked with providing in-depth analysis.\n"
            f"Use all the information at your disposal, such as uploaded files and other sources. "
            f"Think about the following statement or question: {row['question']}\n"
            f"Below are the possible answers, where letters mark each answer. "
            f"First, exclude the unlikely answer or answers, rethink, and select an output from the rest. "
            f"The output is only ONE letter from the list {resp_labels}. "
            f"Check that you return only one letter; if two letters, choose one. No explanations. The answers are:\n"
            f"{question_string}"
        )
        prompts_for_model.append(base_prompt)
        prompts_for_retrieval.append(f"{row['question']} The answers are: {question_string}")
    return prompts_for_retrieval, prompts_for_model


async def _completion_with_backoff(session, url, headers, body, retries=5):
    for attempt in range(retries):
        try:
            r = await session.post(url, headers, body, timeout=180)
            if r.status == 429 and attempt < retries - 1:
                await asyncio.sleep(2 ** attempt)
                continue
            r.raise_for_status()
            data = r.json()
            content = data["choices"][0]["message"]["content"]
            try:
                return json.loads(content)
            except (json.JSONDecodeError, TypeError):
                return {"answer": str(content).strip()[:1]}
        except Exception:
            if attempt == retries - 1:
                raise
            await asyncio.sleep(2 ** attempt)


async def send_to_model_async(gpt_model, qa_table, enable_context, topk, chunk,
                              processor, model, dataset, images_per_pdf, base_url=None):
    """The evaluation of one model/retriever pair (reference 05:252-301)."""
    from multimodal_colpali_tpu_torch import api

    retrieval_prompts, model_prompts = build_query_prompts(qa_table)
    info_res: List[List[str]] = []
    prompt_messages: List[List[dict]] = []
    if enable_context:
        retrieved_results = []
        for batch in batched(retrieval_prompts, chunk):
            retrieved_results.extend(
                api.score_results(batch, processor, model, dataset, images_per_pdf, topk))
        for base_prompt, retrieved in zip(model_prompts, retrieved_results):
            info_res.append([f"{e['file_name'].split('.')[0]}_pg_{e['page_id']}"
                             for e in retrieved])
            images = [e["image"] for e in retrieved]
            content = ([{"type": "text", "text": base_prompt},
                        {"type": "text", "text": "Context information:"}]
                       + _image_parts(images))
            prompt_messages.append([{"role": "user", "content": content}])
    else:
        info_res = [[] for _ in model_prompts]
        prompt_messages = [[{"role": "user", "content": [{"type": "text", "text": p}]}]
                           for p in model_prompts]

    url, headers = resolve_endpoint(gpt_model, base_url=base_url)
    body_extra = {"response_format": mcq_response_format()}
    async with ClientSession(limit=64) as session:
        completions = await asyncio.gather(*[
            _completion_with_backoff(session, url, headers,
                                     {"model": gpt_model, "messages": msg, **body_extra})
            for msg in prompt_messages])
    return [c["answer"] for c in completions], info_res


def load_or_embed(retriever: Any, retriever_name: str, cache_dir: Path, pdf_dir: Path,
                  dynamic_resolution: bool = False) -> List[dict]:
    """The corpus embeddings: the cache file if present, else
    ``PipelinedEmbedder`` over ``pdf_dir``, written to the cache."""
    suffix = "_dynres" if dynamic_resolution else ""
    cache_path = cache_dir / f"{retriever_name.replace('/', '_')}_pdf_emb{suffix}.pkl"
    if cache_path.exists():
        with cache_path.open("rb") as fp:
            return pickle.load(fp)
    from multimodal_colpali_tpu_torch.ingest.pipeline import PipelinedEmbedder

    dataset = PipelinedEmbedder(retriever, batch_size=32).embed_pdf_dir(str(pdf_dir))
    with cache_path.open("wb") as fp:
        pickle.dump(dataset, fp)
    return dataset


def eval_fn(model_name, retriever_name, qa_data: Table, iterations, topk, chunk,
            results_dir: Path, cache_dir: Path, pdf_dir: Path, enable_context: bool,
            base_url=None, dynamic_resolution: bool = False, device: Any = "cuda"):
    """The iterations of one generator/retriever pair (reference 05:375-434)."""
    from multimodal_colpali_tpu_torch.ingest import convert_pdf_dir_to_images
    from multimodal_colpali_tpu_torch.models import load_retriever

    retriever = load_retriever(retriever_name, device=device,
                               dynamic_resolution=dynamic_resolution)
    dataset = load_or_embed(retriever, retriever_name, cache_dir, pdf_dir, dynamic_resolution)
    images_per_pdf = convert_pdf_dir_to_images(str(pdf_dir), device=device)

    for iteration in range(iterations):
        print(f"Processing iteration {iteration + 1}/{iterations} for "
              f"model {model_name} with retriever {retriever_name}.")
        answers, context_info = run_sync(send_to_model_async(
            model_name, qa_data, enable_context, topk, chunk, retriever.processor, retriever,
            dataset, images_per_pdf, base_url=base_url))
        frame = (qa_data.with_column("Model", model_name)
                 .with_column("Model_ret", retriever_name)
                 .with_column("Answer", answers)
                 .with_column("Context_papers", [str(ci) for ci in context_info]))
        frame = frame.with_column("Cor_answer", [int(a == c) for a, c in
                                                 zip(frame["Answer"], frame["Correct"])])
        output_name = (f"eval_{retriever_name.split('/')[-1].split('-')[0]}_{model_name}_"
                       f"{strftime('%Y%m%d%H%M%S', gmtime())}.csv")
        eval_path = results_dir / output_name
        # second-resolution names collide when an iteration takes under a second
        k = 1
        while eval_path.exists():
            eval_path = results_dir / output_name.replace(".csv", f"_{k}.csv")
            k += 1
        frame.to_csv(eval_path)
        accuracy = sum(frame["Cor_answer"]) / len(frame) if len(frame) else float("nan")
        print(f"Saved results to {eval_path} | Accuracy: {accuracy:.3f}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    pdf_dir, results_dir, cache_dir = Path(args.pdf_dir), Path(args.results_dir), Path(args.cache_dir)
    for d in (pdf_dir, results_dir, cache_dir):
        d.mkdir(parents=True, exist_ok=True)
    qa_data = read_table(args.qa_path).sample(args.seed)
    for generator_model in args.models:
        for retriever_model in args.retrievers:
            eval_fn(generator_model, retriever_model, qa_data, args.iterations, args.top_k,
                    args.chunk, results_dir, cache_dir, pdf_dir, args.context,
                    base_url=args.base_url, dynamic_resolution=args.dynamic_resolution,
                    device=args.device)


if __name__ == "__main__":
    main()
