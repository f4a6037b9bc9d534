"""The reference-compatible surface (counterpart of
``multimodal_colpali_tpu/api.py``).

Names, signatures and payloads follow the reference's ``functions.py`` as
the JAX package does:

- ColPali: indexing (``colpali_qdrant``), the Qdrant-style search
  (``retrieve_colpali``) and the in-memory scoring of experiment 02
  (``score_results``). ``model`` is a
  :class:`~multimodal_colpali_tpu_torch.models.Retriever`; queries are
  encoded and scored on its device.
- The dense RAG modes (api.py:243-726): ``qdrant_process`` and
  ``TpuVectorStore`` over a dense collection, with ``embeddings`` a
  :class:`~multimodal_colpali_tpu_torch.models.text_encoder.BgeEmbeddings`;
  the prompt functions of the three retrieval modes (``prompt_prep_query``:
  no-RAG, mm_RAG, colpali); the multi-user collection management and the
  tarball snapshots.

Not ported yet, each raising ``NotImplementedError``: the image-summary and
model-discovery functions (``get_img_summary``, ``process_models``,
``models_local``, ``models_used``), which need the HTTP client (ROADMAP
queue 1 item 2), and ``create_document_embeddings``, which needs the PDF
ingest stage (item 4).
"""

from __future__ import annotations

import os
import pickle
import tarfile
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from multimodal_colpali_tpu_torch.documents import Document
from multimodal_colpali_tpu_torch.generation.messages import format_msgs
from multimodal_colpali_tpu_torch.models.processing import pad_multivectors
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties
from multimodal_colpali_tpu_torch.store import (
    Distance, FieldCondition, Filter, FilterSelector, MatchAny, MatchValue,
    MultiVectorConfig, PointStruct, QuantizationSearchParams, SearchParams, VectorClient,
    VectorParams)


def _not_ported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"api.{name} is not ported to PyTorch yet (ROADMAP.md "
                               f"queue 1 {item})")


def create_document_embeddings(pdf_dir: str, model, processor=None, batch_size: int = 32):
    """Embed every page of every PDF in a directory (api.py:46-70): needs
    the PDF ingest stage, not ported yet."""
    raise _not_ported("create_document_embeddings", "item 4, ingest")


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
                              max_tokens: int = 1056, quantized: bool = False,
                              on_disk: bool = False) -> None:
    """128-d COSINE multivector MAX_SIM collection
    (reference 01_create_context_qdrant.py:208-222; api.py:138-156).
    ``on_disk`` mirrors the reference's VectorParams(on_disk=True): the
    originals stay off the accelerator and queries rescore host-gathered
    candidates."""
    if not client.collection_exists(name):
        client.create_collection(
            name,
            vectors_config=VectorParams(size=vector_size, distance=Distance.COSINE,
                                        multivector_config=MultiVectorConfig(),
                                        on_disk=on_disk),
            max_tokens=max_tokens,
            quantized=quantized,
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


# ---------------------------------------------------------------------------
# Dense collections (reference functions.py:1310-1333) + similarity search
# ---------------------------------------------------------------------------

def qdrant_process(
    docs: Sequence[Document],
    qdrant_client: VectorClient,
    vec_db: str,
    emb_dim: int,
    embeddings,
    url: str = "",
) -> None:
    """Create a dense cosine collection and index LangChain-shaped docs
    (api.py:243-272). Payloads follow langchain-qdrant, ``{"page_content":
    ..., "metadata": {...}}``, so filters like ``metadata.document_name``
    work."""
    print(f"Processing data for colection {vec_db}.")
    if not qdrant_client.collection_exists(vec_db):
        qdrant_client.create_collection(
            vec_db, vectors_config=VectorParams(size=emb_dim, distance=Distance.COSINE))
    vecs = embeddings.embed_documents([d.page_content for d in docs])
    points = [
        PointStruct(id=str(uuid.uuid4()), vector=v,
                    payload={"page_content": d.page_content, "metadata": dict(d.metadata)})
        for d, v in zip(docs, vecs)
    ]
    qdrant_client.upsert(vec_db, points)
    print(f"Processing of {len(docs)} for colection {vec_db} complete.")


def _documents(points) -> List[Tuple[Document, float]]:
    """Scored points with langchain payloads -> (Document, score) pairs."""
    return [(Document(page_content=p.payload.get("page_content", ""),
                      metadata=dict(p.payload.get("metadata", {}))), p.score)
            for p in points]


class TpuVectorStore:
    """``similarity_search_with_score`` over a dense collection: the
    LangChain ``QdrantVectorStore`` seam of reference 02_experiment01.py:139
    (api.py:275-304; the name is the JAX package's, kept for the pipeline scripts)."""

    def __init__(self, client: VectorClient, collection_name: str, embedding):
        self.client = client
        self.collection_name = collection_name
        self.embedding = embedding

    def similarity_search_with_score(
        self, query: str, k: int = 5, filter: Optional[Filter] = None,
    ) -> List[Tuple[Document, float]]:
        qv = self.embedding.embed_query(query)
        res = self.client.query_points(self.collection_name, query=qv, limit=k,
                                       query_filter=filter)
        return _documents(res.points)

    @classmethod
    def from_documents(cls, docs, embedding, client: VectorClient, collection_name: str,
                       emb_dim: int = 768, **_: Any):
        qdrant_process(docs, client, collection_name, emb_dim, embedding)
        return cls(client, collection_name, embedding)


# ---------------------------------------------------------------------------
# Image summarization pipeline (reference functions.py:996-1308)
# ---------------------------------------------------------------------------

def _doc_prompt(doc: Document, prompt_image: str, prompt_text: str):
    """One doc's message list: an image doc's picture under ``prompt_image``,
    a text or table doc's text after ``prompt_text``, anything else
    ``prompt_text`` alone."""
    if doc.metadata["type"] in ["image"]:
        return format_msgs(prompt_image, [doc.metadata["img_link"]], "")
    if doc.metadata["type"] in ["text", "table"]:
        return format_msgs(prompt_text, [], doc.page_content)
    return format_msgs(prompt_text, [], "")


def prompt_prep(docs: Sequence[Document], prompt_image: str, prompt_text: str):
    """Docs -> per-doc OpenAI message lists (reference functions.py:996-1013)."""
    return [_doc_prompt(el, prompt_image, prompt_text) for el in docs]


def modify_orig(orig_documents, gen_texts):
    """Replace image docs' text with generated summaries, zip-ordered
    (reference functions.py:616-631)."""
    new_doc = []
    for gen_text, el in zip(gen_texts, orig_documents):
        if el.metadata["type"] in ["image"]:
            el.page_content = gen_text
        new_doc.append(el)
    return new_doc


def show_results(qdrant_retrieval, display_fn=print):
    """Print a retrieval result set (reference functions.py:633-651; JAX
    api.py:336-366): headless, so entries are printed and returned as
    ``(kind, payload)`` tuples for the caller to render."""
    shown = []
    if hasattr(qdrant_retrieval, "points"):
        for el in qdrant_retrieval.points:
            display_fn(
                f"Score: {el.score}, file: {el.payload['document_name']}, "
                f"page: {el.payload['page_no']}, type: {el.payload['type']}, "
                f"link: {el.payload['document_link']}. ")
            shown.append(("image", el.payload.get("img_link")))
    else:
        for el in qdrant_retrieval:
            doc, score = el[0], el[1]
            display_fn(
                f"Score: {score}, file: {doc.metadata['document_name']}, "
                f"page: {doc.metadata['page_no']}, type: {doc.metadata['type']}, "
                f"link: {doc.metadata['document_link']}. ")
            kind = doc.metadata["type"]
            if kind in ["image", "pdf_page"]:
                shown.append(("image", doc.metadata.get("img_link")))
            elif kind in ["text"]:
                display_fn(f"{doc.page_content} \n")
                shown.append(("text", doc.page_content))
            elif kind in ["table"]:
                shown.append(("markdown", doc.page_content))
    return shown


async def get_img_summary(docs_multi, prompts, model, vllm_port, save_output,
                          base_url: Optional[str] = None):
    """Replace image docs' text with VLM summaries (api.py:484-503): needs
    the HTTP client, not ported yet."""
    raise _not_ported("get_img_summary", "item 2, the HTTP client")


async def process_models(processed_multi, prompts, MODELS, base_url: Optional[str] = None):
    """Per-model image summaries (api.py:506-516): needs the HTTP client."""
    raise _not_ported("process_models", "item 2, the HTTP client")


def models_local(ports: Sequence[int], api_key: str = "EMPTY"):
    """Probe local OpenAI endpoints (api.py:523-541): needs the HTTP client."""
    raise _not_ported("models_local", "item 2, the HTTP client")


def models_used(local_ports, gpt_models, VD_text, VD_MM):
    """Merge local and GPT model configs (api.py:544-556): needs the HTTP client."""
    raise _not_ported("models_used", "item 2, the HTTP client")


# ---------------------------------------------------------------------------
# Query-time prompt preparation (reference functions.py:1479-1665)
# ---------------------------------------------------------------------------

def _context_prompts(context_docs, prompt_image: str, prompt_text: str, join_context: bool):
    """(Document, score) context -> per-item or joined multimodal prompts
    (the shared tail of the reference's three prompt_prep_query variants)."""
    if not join_context:
        return [_doc_prompt(el[0], prompt_image, prompt_text) for el in context_docs]
    img_links = [el[0].metadata["img_link"] for el in context_docs
                 if el[0].metadata["type"] in ["image"]]
    text_joined = "\n".join(el[0].page_content for el in context_docs
                            if el[0].metadata["type"] in ["text", "table"])
    return format_msgs(prompt_image, img_links, text_joined)


def _user_filter(key: str, username: str) -> Filter:
    return Filter(must=[FieldCondition(key=key, match=MatchValue(value=username))])


def prompt_prep_query(query, prompts, qdrant_client, username, vector_db, embeddings,
                      top_k, type, cp_model="", cp_processor="", join_context=False):
    """Retrieve top-k context for ``query`` and build generation prompts
    (reference functions.py:1479-1557; api.py:400-432): ``type`` selects
    no-RAG (''), mm_RAG (dense similarity search under a username filter) or
    colpali (late-interaction MaxSim through :func:`retrieve_colpali`);
    ``join_context`` merges all context into one multimodal prompt instead of
    one prompt per hit."""
    prompt_image = prompts.format(query=query)
    prompt_text = prompts.format(query=query)
    if type in ["", "mm_RAG"]:
        if type == "":
            context = []
        else:
            store = TpuVectorStore(qdrant_client, vector_db, embeddings)
            context = store.similarity_search_with_score(
                query, top_k, filter=_user_filter("metadata.username", username))
        q_prompt = _context_prompts(context, prompt_image, prompt_text, join_context)
    elif type == "colpali" and cp_processor != "" and cp_model != "":
        context = retrieve_colpali(query, cp_processor, cp_model, qdrant_client, username,
                                   vector_db, top_k)
        img_links = [el.payload["img_link"] for el in context.points]
        if not join_context:
            q_prompt = [format_msgs(prompt_image, [link], "") for link in img_links]
        else:
            q_prompt = format_msgs(prompt_image, img_links, "")
    else:
        print("Error, either enter mm_RAG or colpali or '' for RAG variable")
        context, q_prompt = [], []
    return {"query": query, "context": context, "q_prompts": q_prompt}


def prompt_prep_query_emb(query, prompts, qdrant_client, username, vector_db, embed_prompt,
                          top_k, type, join_context=False):
    """:func:`prompt_prep_query` over a precomputed dense query embedding
    (reference functions.py:1559-1610; api.py:435-454): queries the
    collection directly and reads the langchain payload layout."""
    prompt_image = prompts["rag_summary_query"].format(query=query)
    prompt_text = prompts["text_summary_query"].format(query=query)
    if type not in ["", "mm_RAG"]:
        print("Error, either enter mm_RAG or '' for RAG variable")
        return {"query": query, "context": [], "q_prompts": []}
    if type == "":
        return {"query": query, "context": "", "q_prompts": format_msgs(prompt_text, [], "")}
    context = qdrant_client.query_points(vector_db, query=embed_prompt, limit=top_k)
    q_prompt = _context_prompts(_documents(context.points), prompt_image, prompt_text,
                                join_context)
    return {"query": query, "context": context, "q_prompts": q_prompt}


def prompt_prep_query1(query, prompts, username, vector_db, embeddings, top_k, type,
                       join_context=False, qdrant_client=None, path: str = ""):
    """:func:`prompt_prep_query` against an existing collection (reference
    functions.py:1612-1665; api.py:457-481): the client given, or one loaded
    from ``path`` on the embeddings' device. Retrieval errors degrade to an
    empty context, as in the reference."""
    prompt_query = prompts.format(query=query)
    context = []
    if type in ["mm_vd", "text_vd"]:
        try:
            client = qdrant_client or VectorClient(path or None,
                                                   device=getattr(embeddings, "device", "cuda"))
            store = TpuVectorStore(client, vector_db, embeddings)
            context = store.similarity_search_with_score(
                query, top_k, filter=_user_filter("metadata.username", username))
        except Exception:  # noqa: BLE001 - mirror the reference's degrade
            context = []
            print("Error accessing qdrant vectorstore")
    elif type != "":
        print("Error, either enter mm_RAG or colpali or '' for RAG variable")
    q_prompt = _context_prompts(context, prompt_query, prompt_query, join_context)
    return {"query": query, "context": context, "q_prompts": q_prompt}


# ---------------------------------------------------------------------------
# Multi-user vector-DB management (reference functions.py:1066-1234, 1769-1948)
# ---------------------------------------------------------------------------

def get_vd_elements(qdrant_client: VectorClient, username: str, vd_name: str, paper_dir: str):
    """Distinct (document_name, document_link) of a dense collection
    (reference functions.py:1168-1199; api.py:563-575)."""
    records, _ = qdrant_client.scroll(
        vd_name,
        scroll_filter=Filter(must_not=[FieldCondition(
            key="metadata.document_name", match=MatchValue(value=""))]),
        limit=100000,
    )
    return _distinct_docs(records, paper_dir, nested=True)


def get_vd_elements_colpali(qdrant_client: VectorClient, username: str, vd_name: str,
                            paper_dir: str):
    """The same for a ColPali collection: flat payloads and a username filter
    (reference functions.py:1201-1234; api.py:578-593)."""
    must = [FieldCondition(key="username", match=MatchValue(value=username))] if username else []
    records, _ = qdrant_client.scroll(
        vd_name,
        scroll_filter=Filter(
            must=must,
            must_not=[FieldCondition(key="document_name", match=MatchValue(value=""))]),
        limit=100000,
    )
    return _distinct_docs(records, paper_dir, nested=False)


def _distinct_docs(records, paper_dir: str, nested: bool):
    """-> (document names sorted, the PDFs under ``paper_dir`` whose path
    contains each name, their document links)."""
    papers = [os.path.join(paper_dir, f) for f in sorted(os.listdir(paper_dir))
              if f.lower().endswith(".pdf")] if os.path.isdir(paper_dir) else []
    seen = set()
    lst = []
    for el in records:
        payload = el.payload.get("metadata", {}) if nested else el.payload
        key = (payload.get("document_name", ""), payload.get("document_link", ""))
        if key not in seen and key[0]:
            seen.add(key)
            lst.append({"document_name": key[0], "document_link": key[1]})
    lst = sorted(lst, key=lambda d: d["document_name"])
    dt = [el["document_name"] for el in lst]
    doi_links = [el["document_link"] for el in lst]
    links = [paper for el in dt for paper in papers if el in paper]
    return dt, links, doi_links


def delete_papers(username: str, vd_list, vd_colpali, file_loc: str, key_value: List[str],
                  qdrant_client: VectorClient, key_name: str = "metadata.document_name",
                  key_link: str = "metadata.img_link") -> None:
    """Delete a user's papers: saved images, PDFs, and points in every
    collection (reference functions.py:1066-1166; api.py:614-676). The
    client is a parameter (the reference hardcoded a server URL)."""
    flat_key = key_name.split(".")[-1]

    def dense_filter():
        return Filter(must=[FieldCondition(key=key_name, match=MatchAny(any=key_value)),
                            FieldCondition(key="metadata.username",
                                           match=MatchValue(value=username))])

    def colpali_filter():
        return Filter(must=[FieldCondition(key=flat_key, match=MatchAny(any=key_value)),
                            FieldCondition(key="username", match=MatchValue(value=username))])

    img_list: List[str] = []
    for vd in vd_list:
        records, _ = qdrant_client.scroll(vd, scroll_filter=dense_filter(), limit=10000)
        for el in records:
            link = el.payload.get(key_link.split(".")[0], {}).get(key_link.split(".")[-1], "")
            if link:
                img_list.append(link)
    for vd in vd_colpali:
        records, _ = qdrant_client.scroll(vd, scroll_filter=colpali_filter(), limit=10000)
        for el in records:
            link = el.payload.get(key_link.split(".")[-1], "")
            if link:
                img_list.append(link)

    for file in sorted(set(img_list)):
        if os.path.isfile(file):
            os.remove(file)
        else:
            print(f"Error: {file} file not found")
    for paper in key_value:
        p = os.path.join(file_loc, "papers", paper)
        if os.path.isfile(p):
            os.remove(p)
        else:
            print(f"Error: {file_loc} file not found")

    for vd in vd_list:
        log = qdrant_client.delete(vd, points_selector=FilterSelector(filter=dense_filter()))
        print(f"For VD {vd}, delete log shows_ {log}")
    for vd in vd_colpali:
        log = qdrant_client.delete(vd, points_selector=FilterSelector(filter=colpali_filter()))
        print(f"For VD {vd}, delete log shows_ {log}")


def update_vd_new_user(qdrant_client: VectorClient, username: str,
                       base_collections: Sequence[str],
                       img_link_map: Optional[Dict[str, str]] = None) -> None:
    """Clone base collections' points for a new user: stamp the username into
    the payload and optionally rewrite img_link prefixes (reference
    functions.py:1812-1858; api.py:679-706)."""
    for coll in base_collections:
        records, _ = qdrant_client.scroll(coll, limit=1000000, with_vectors=True)
        points = []
        for el in records:
            payload = dict(el.payload)
            nested = "metadata" in payload
            target = dict(payload["metadata"] if nested else payload)
            target["username"] = username
            if img_link_map:
                link = target.get("img_link", "")
                for old, new in img_link_map.items():
                    if link.startswith(old):
                        target["img_link"] = new + link[len(old):]
            if nested:
                payload["metadata"] = target
            else:
                payload = target
            points.append(PointStruct(id=str(uuid.uuid4()), vector=el.vector, payload=payload))
        if points:
            qdrant_client.upsert(coll, points)


# ---------------------------------------------------------------------------
# Snapshots (reference functions.py:457-461, 1860-1948)
# ---------------------------------------------------------------------------

def make_tarfile(output_filename: str, source_dir: str) -> None:
    """Snapshot a directory (reference functions.py:1860-1868)."""
    with tarfile.open(output_filename, "w:gz") as tar:
        tar.add(source_dir, arcname=os.path.basename(source_dir))


def setup_initial_vector_db(tar_path: str, vd_dir: str) -> None:
    """Seed a user's vector DB from a tarball snapshot
    (reference functions.py:1870-1948, minus its dead-variable bug)."""
    os.makedirs(vd_dir, exist_ok=True)
    with tarfile.open(tar_path, "r:gz") as tar:
        tar.extractall(vd_dir, filter="data")


def extract_tarfile(input_filename: str, output_dir: str) -> None:
    """Unpack a snapshot tarball (reference functions.py:1863-1864)."""
    setup_initial_vector_db(input_filename, output_dir)


def save_to_pickle(filepath: str, **kwargs) -> None:
    """reference functions.py:457-461."""
    with open(filepath, "wb") as f:
        pickle.dump(kwargs, f)
