"""The reference-compatible retrieval surface (counterpart of the retrieval
subset of ``multimodal_colpali_tpu/api.py``).

Names, signatures and payloads follow the reference's ``functions.py`` as
the JAX package does: indexing (``colpali_qdrant``), the Qdrant-style
search (``retrieve_colpali``) and the in-memory scoring of experiment 02
(``score_results``). ``model`` is a :class:`~multimodal_colpali_tpu_torch.models.Retriever`;
queries are encoded and scored on its device.

``create_document_embeddings`` is not ported yet: it needs the PDF ingest
stage, which lives in the JAX package.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Sequence

import torch

from multimodal_colpali_tpu_torch.models.processing import pad_multivectors
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties
from multimodal_colpali_tpu_torch.store import (
    Distance, FieldCondition, Filter, MatchValue, MultiVectorConfig, PointStruct,
    QuantizationSearchParams, SearchParams, VectorClient, VectorParams)


def upsert_to_qdrant(client: VectorClient, collection_name: str, points,
                     attempts: int = 3) -> bool:
    """Retrying upsert (reference functions.py:814-825, api.py:77-95).

    Shape errors (ValueError) and a missing collection (KeyError) propagate
    at once: retrying cannot fix them."""
    for i in range(attempts):
        try:
            client.upsert(collection_name, points)
            return True
        except (ValueError, KeyError):
            raise
        except Exception as e:  # noqa: BLE001 - transient: report and retry
            print(f"Error during upsert: {e}")
            if i == attempts - 1:
                return False
    return False


def colpali_qdrant(
    dataset: Sequence[Dict[str, Any]],
    papers: Sequence[str],
    doi: Sequence[str],
    model,
    processor,
    qdrant_client: VectorClient,
    qdrant_collection: str,
    batch_size: int = 32,
    username: str = "",
) -> None:
    """Embed page images and upsert multivector points with the reference's
    payload schema (functions.py:827-873). ``dataset`` entries:
    {image, filename, page_no, img_link}."""
    doi_by_paper = {p.split("/")[-1]: d for p, d in zip(papers, doi)}
    for start in range(0, len(dataset), batch_size):
        batch = dataset[start: start + batch_size]
        embeddings = model.embed_images([item["image"] for item in batch],
                                        batch_size=batch_size)
        points = []
        for item, emb in zip(batch, embeddings):
            payload = {
                "document_name": item["filename"],
                "document_id": str(uuid.uuid4()),
                "document_link": doi_by_paper.get(item["filename"], ""),
                "type": "pdf_page",
                "page_no": item["page_no"],
                "ref": "",
                "caption": "",
                "img_link": item.get("img_link", ""),
            }
            if username:
                payload["username"] = username
            points.append(PointStruct(id=str(uuid.uuid4()), vector=emb, payload=payload))
        upsert_to_qdrant(qdrant_client, qdrant_collection, points)
    print("Indexing complete!")


def ensure_colpali_collection(client: VectorClient, name: str, vector_size: int = 128,
                              max_tokens: int = 1056) -> None:
    """128-d COSINE multivector MAX_SIM collection
    (reference 01_create_context_qdrant.py:208-222). The JAX package's
    ``quantized`` and ``on_disk`` collections are not ported yet."""
    if not client.collection_exists(name):
        client.create_collection(
            name,
            vectors_config=VectorParams(size=vector_size, distance=Distance.COSINE,
                                        multivector_config=MultiVectorConfig()),
            max_tokens=max_tokens,
        )


def retrieve_colpali(
    query: str,
    processor,
    model,
    qdrant_client: VectorClient,
    username: str,
    colection_name: str,
    top_k: int,
):
    """Late-interaction retrieval: encode the query, exact MaxSim search.

    Same signature and printout as the reference (functions.py:884-929),
    including the misspelled ``colection_name`` and the quantization search
    params (ignore=True: the exact scan)."""
    token_query = model.embed_queries([query])[0]
    start_time = time.time()
    kwargs: Dict[str, Any] = dict(
        limit=top_k,
        search_params=SearchParams(quantization=QuantizationSearchParams(
            ignore=True, rescore=True, oversampling=2.0)),
    )
    if username != "":
        kwargs["query_filter"] = Filter(
            must=[FieldCondition(key="username", match=MatchValue(value=username))])
    result = qdrant_client.query_points(colection_name, query=token_query, **kwargs)
    print(f"Time taken = {(time.time()-start_time):.3f} s")
    return result


def score_results(
    queries: List[str],
    processor,
    model,
    dataset: List[Dict[str, Any]],
    images_per_pdf: Dict[str, List[Any]],
    top_k: int,
) -> List[List[Dict[str, Any]]]:
    """Top-k pages per query by MaxSim over an in-memory corpus
    (reference 05_experiment02.py:200-236), scored on the model's device."""
    device = model.device
    q_pad, q_lens = pad_multivectors(model.embed_queries(queries))
    d_pad, d_lens = pad_multivectors([e["embedding"] for e in dataset])
    scores = maxsim_scores(
        torch.from_numpy(q_pad).to(device), torch.from_numpy(d_pad).to(device),
        torch.from_numpy(q_lens).to(device), torch.from_numpy(d_lens).to(device))
    vals, inds = topk_with_stable_ties(scores, min(top_k, len(dataset)))
    vals, inds = vals.cpu().numpy(), inds.cpu().numpy()

    retrieved = []
    for qi in range(len(queries)):
        results = []
        for score, idx in zip(vals[qi].tolist(), inds[qi].tolist()):
            entry = dataset[idx]
            results.append({
                "doc_id": entry["doc_id"],
                "page_id": entry["page_id"],
                "file_name": entry["file_name"],
                "image": images_per_pdf[entry["file_name"]][entry["page_id"]],
                "score": score,
            })
        retrieved.append(results)
    return retrieved
