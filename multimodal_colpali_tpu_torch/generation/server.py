"""OpenAI-compatible generation server (counterpart of
``multimodal_colpali_tpu/generation/server.py:29-520``).

The reference's generation tier is a vLLM container exposing
``/v1/chat/completions``; this server speaks the same protocol from the
port's ``GemmaDecodeEngine`` or one of its batchers, so a GPU host serves
its own generation. Point an OpenAI client's ``base_url`` at it.

Scope: chat completions with string, text-part and ``image_url`` content
(base64 PNG or JPEG data URLs, decoded by the port's own decoders to
Pillow's pixels; with an ``mm_engine``, every image of a request conditions
its answer),
``max_tokens``, ``temperature``, ``top_p``, ``top_k``, ``seed``,
``logprobs``, ``stop`` via the tokenizer's eos, constrained enum outputs
(``response_format``), SSE streaming (``stream: true``, per token with a
batcher), 429/504 back-pressure from the batcher's bounded queue and
admission deadline, ``/health``, and ``/stats``: the requests served, the
images decoded and skipped, and how many requests carried each number of
decoded images.
"""

from __future__ import annotations

import base64
import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from multimodal_colpali_tpu_torch.generation.engine import LOGPROB_K
from multimodal_colpali_tpu_torch.generation.scheduler import AdmissionQueueFull
from multimodal_colpali_tpu_torch.ingest.imageops import decode_image


def render_chat_prompt(messages: List[Dict[str, Any]]) -> str:
    """Flatten OpenAI chat messages into a plain prompt (text parts only)."""
    return extract_chat_content(messages)[0]


def _decode_image(url: str):
    """A base64 data URL -> uint8 ``[H, W, 3]`` RGB, Pillow's pixels
    (``imageops.decode_image``: PNG and JPEG with the port's own decoders),
    or None where it does not decode: such a part is skipped, as in
    server.py:53-60."""
    if not url.startswith("data:"):
        return None
    try:
        raw = base64.b64decode(url.split(",", 1)[1])
    except (ValueError, IndexError):
        return None
    return decode_image(raw)


def _image_parts(messages: List[Dict[str, Any]]) -> int:
    return sum(1 for m in messages if isinstance(m.get("content"), list)
               for p in m["content"] if isinstance(p, dict) and p.get("type") == "image_url")


def extract_chat_content(messages: List[Dict[str, Any]]):
    """-> (prompt text, [RGB arrays]) from OpenAI chat messages; ``image_url``
    parts carry base64 data URLs (the reference's encode_image_to_data_url
    format)."""
    lines = []
    images = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):
            texts = []
            for part in content:
                if not isinstance(part, dict):
                    continue
                if part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    img = _decode_image((part.get("image_url") or {}).get("url", ""))
                    if img is not None:
                        images.append(img)
            content = " ".join(texts)
        lines.append(f"{m.get('role', 'user')}: {content}")
    lines.append("assistant:")
    return "\n".join(lines), images


class GenerationServer:
    """Serve ``/v1/chat/completions`` from a decode engine + tokenizer.

    ``engine`` must expose ``generate(prompts, max_new_tokens, temperature,
    eos_id, seed) -> [[token_id, ...]]`` (a batcher also ``submit``);
    ``tokenizer`` must expose ``encode``/``decode`` (and optionally
    ``eos_id``). ``mm_engine`` (a ``PaliGemmaEngine`` or ``Gemma3MMEngine``) and
    ``image_preprocessor`` (images -> normalized ``[N, H, W, 3]``) answer
    requests with images; a batcher built with the same ``mm_engine`` serves
    them in its slot batch, otherwise the engine generates them itself.
    """

    def __init__(self, engine: Any, tokenizer: Any, model_name: str = "local",
                 host: str = "127.0.0.1", port: int = 0,
                 max_new_tokens: int = 128,
                 mm_engine: Any = None, image_preprocessor: Any = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.default_max_new = max_new_tokens
        self.mm_engine = mm_engine
        self.image_preprocessor = image_preprocessor
        # constrained requests run their prefill outside the batcher, each
        # with caches of its own: one at a time, or a burst of them (an MCQ
        # sweep sends 120 at once) holds all their caches on the card at
        # once and runs out of memory
        self._constrained_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "images_decoded": 0, "images_skipped": 0,
                       "images_per_request": collections.Counter()}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.rstrip("/")
                if path.endswith("health") or path.endswith("stats"):
                    body = (b'{"status": "ok"}' if path.endswith("health")
                            else json.dumps(outer.stats()).encode())
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if req.get("stream"):
                        # only raises BEFORE headers are written; post-header
                        # errors surface as an SSE error event instead
                        outer._stream_complete(req, self)
                        return
                    resp = outer._complete(req)
                    code = 200
                except Exception as e:  # noqa: BLE001 - protocol error reply
                    resp = {"error": {"message": str(e), "type": type(e).__name__}}
                    # back-pressure surfaces as retryable statuses (the
                    # reference's client backs off on them,
                    # functions.py:1017-1034): 429 = bounded admission
                    # queue full, 504 = admission deadline expired
                    code = (429 if isinstance(e, AdmissionQueueFull)
                            else 504 if isinstance(e, TimeoutError) else 400)
                body = json.dumps(resp).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class Server(ThreadingHTTPServer):
            # the reference's client fires ALL its requests at once
            # through TCPConnector(limit=512) (functions.py:1050): the
            # default listen backlog of 5 resets connections under that
            # burst, so match the connector's fan-out
            request_queue_size = 512
            daemon_threads = True

        self._httpd = Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self.base_url = f"http://{self.host}:{self.port}/v1"
        self._thread: Optional[threading.Thread] = None

    # -- protocol ------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The requests served so far and their images (``GET /stats``)."""
        with self._stats_lock:
            st = dict(self._stats)
            st["images_per_request"] = {str(k): v for k, v in
                                        sorted(st["images_per_request"].items())}
            return st

    def _note_images(self, req: Dict[str, Any], images: List[Any]) -> None:
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["images_decoded"] += len(images)
            self._stats["images_skipped"] += _image_parts(req.get("messages", [])) - len(images)
            self._stats["images_per_request"][len(images)] += 1

    @staticmethod
    def _schema_enum(req: Dict[str, Any]) -> Optional[tuple]:
        """(field, choices) when response_format is a single-enum-field
        json_schema (the reference's MCQ structured output,
        02_experiment01.py:50-55 / generation/client.mcq_response_format)."""
        rf = req.get("response_format") or {}
        if rf.get("type") != "json_schema":
            return None
        props = (rf.get("json_schema", {}).get("schema", {})
                 .get("properties", {}))
        for field, spec in props.items():
            if isinstance(spec, dict) and spec.get("enum"):
                return field, list(spec["enum"])
        return None

    def _constrained_choice(self, prompt: str, field: str, choices: List[str],
                            images=None) -> str:
        """Constrained decoding for enum outputs: force the JSON scaffold as
        prompt text and pick the choice whose first token the model scores
        highest (server.py:167-203); with images and an ``mm_engine``, the
        logits are conditioned on all of them. The forwards run one at a
        time (``_constrained_lock``); the JAX server runs them all at once."""
        scaffold, ids, first_tokens = self._constrained_prompt(prompt, field, choices)
        if images and self.mm_engine is not None:
            pix = self.image_preprocessor(images)        # [N, H, W, 3]
            ids = self.mm_engine.build_mm_prompt(
                self._encode(scaffold), bos_id=getattr(self.tokenizer, "bos_id", 2),
                n_images=len(images))
            with self._constrained_lock:
                logits = self.mm_engine.next_token_logits([ids], pix[None])[0]
        else:
            engine = getattr(self.engine, "engine", self.engine)  # unwrap a batcher
            with self._constrained_lock:
                logits = engine.next_token_logits([ids])[0]
        best = choices[int(np.argmax([logits[t] for t in first_tokens]))]
        return json.dumps({field: best})

    def _constrained_prompt(self, prompt: str, field: str, choices: List[str]):
        """-> (the JSON scaffold forced as prompt text, its token ids for a
        text-only forward (BOS first), the first token of each choice past
        the scaffold): what :meth:`_constrained_choice` scores."""
        scaffold = prompt + f'\n{{"{field}": "'
        # Context-aware choice tokens: tokenize scaffold+choice and take the
        # first token PAST the scaffold - encode(choice) alone returns the
        # standalone form (or a BOS) under SentencePiece/BPE tokenizers,
        # which scores the wrong vocabulary rows.
        base_len = len(self._encode(scaffold))
        first_tokens = []
        for c in choices:
            full = self._encode(scaffold + c)
            first_tokens.append(full[base_len] if len(full) > base_len
                                else full[-1])
        return scaffold, self._encode(scaffold, add_special_tokens=True), first_tokens

    def _encode(self, text: str, add_special_tokens: bool = False):
        """Encode through any tokenizer honoring the documented contract
        (``encode``/``decode``): tokenizers without an
        ``add_special_tokens`` kwarg (e.g. SimpleTokenizer) get the bos
        prepended here instead of raising TypeError."""
        try:
            return list(self.tokenizer.encode(
                text, add_special_tokens=add_special_tokens))
        except TypeError:
            ids = list(self.tokenizer.encode(text))
            if add_special_tokens and hasattr(self.tokenizer, "bos_id"):
                ids = [self.tokenizer.bos_id] + ids
            return ids

    request_timeout: float = 3600.0

    def _parse_sampling(self, req: Dict[str, Any]):
        """(max_new, temperature, top_p, top_k, seed) - explicit None
        checks, NOT ``or`` defaults: ``top_p: 0`` is OpenAI's greedy
        extreme and must stay 0 (the filter clamps it to top-1), not be
        coerced to 1.0 (full-vocab sampling, the opposite)."""
        if req.get("max_tokens") is not None:
            max_new = int(req["max_tokens"])
            if max_new < 1:
                raise ValueError("max_tokens must be >= 1")
        else:
            max_new = self.default_max_new
        temperature = (float(req["temperature"])
                       if req.get("temperature") is not None else 0.0)
        top_p = float(req["top_p"]) if req.get("top_p") is not None else 1.0
        top_k = int(req["top_k"]) if req.get("top_k") is not None else 0
        return max_new, temperature, top_p, top_k, int(req.get("seed") or 0)

    def _prepare_ids(self, prompt: str, images):
        """-> (token ids, pixels ``[N, H, W, 3]`` or None) (server.py:240-256):
        with images and an ``mm_engine`` the ids lead with every image's
        tokens and close the prefix with a newline."""
        ids = self._encode(prompt, add_special_tokens=True)
        if not (images and self.mm_engine is not None):
            return ids, None
        pix = self.image_preprocessor(images)
        ids = self.mm_engine.build_mm_prompt(
            self._encode(prompt), bos_id=getattr(self.tokenizer, "bos_id", 2),
            newline_ids=self._encode("\n"), n_images=len(images))
        return ids, pix

    def _start_generation(self, ids, pix, max_new, temperature, top_p,
                          top_k, seed, logprobs: int = 0, on_token=None):
        """One dispatch point for streaming AND non-streaming requests.

        Returns a zero-arg ``wait()`` producing ``(tokens, lps|None,
        tops|None)``. Batcher engines go through ``submit`` (per-token
        callbacks, logprobs, shared slot batch; ``pix`` is the request's own
        ``[N, H, W, 3]`` stack); bare engines, and image requests to a
        batcher without an ``mm_engine``, generate synchronously inside
        ``wait`` (no incremental stream, no logprobs)."""
        eos_id = getattr(self.tokenizer, "eos_id", -1)
        submit = getattr(self.engine, "submit", None)
        if submit is not None and (pix is None
                                   or getattr(self.engine, "supports_multimodal", False)):
            fut = submit(ids, max_new_tokens=max_new,
                         temperature=temperature, eos_id=eos_id, seed=seed,
                         pixel_values=pix, on_token=on_token, top_p=top_p, top_k=top_k,
                         logprobs=logprobs)

            def wait():
                res = fut.result(timeout=self.request_timeout)
                return res if logprobs else (res, None, None)

            wait.future = fut
            return wait

        def wait():
            # bare engines generate synchronously; no per-token callbacks
            # (the streaming caller emits wait()'s text in one chunk)
            if pix is not None:
                out = self.mm_engine.generate(
                    [ids], pix[None], max_new_tokens=max_new, temperature=temperature,
                    eos_id=eos_id, seed=seed, top_p=top_p, top_k=top_k)[0]
            else:
                out = self.engine.generate(
                    [ids], max_new_tokens=max_new, temperature=temperature,
                    eos_id=eos_id, seed=seed, top_p=top_p, top_k=top_k)[0]
            return out, None, None

        wait.future = None
        return wait

    def _stream_complete(self, req: Dict[str, Any], handler) -> None:
        """``stream: true`` - serve the completion as OpenAI SSE
        (``chat.completion.chunk`` events ending in ``data: [DONE]``), the
        protocol vLLM streams (the reference's generation server). With a
        ContinuousBatcher engine, tokens stream as the scheduler syncs each
        decoded chunk; other configurations (bare engines, constrained
        enum outputs) generate fully and emit one content chunk.

        Raises only before the response headers are written; later errors
        are emitted as an SSE ``error`` event so the connection terminates
        cleanly instead of leaving half a JSON body."""
        import queue as _queue

        max_new, temperature, top_p, top_k, seed = self._parse_sampling(req)
        prompt, images = extract_chat_content(req.get("messages", []))
        self._note_images(req, images)
        enum = self._schema_enum(req)
        rid = f"chatcmpl-{int(time.time() * 1e3)}"
        created = int(time.time())
        model = req.get("model", self.model_name)
        # streaming logprobs (vLLM/OpenAI SSE surface): each content chunk
        # carries the records of the tokens it delivers; concatenating
        # chunk logprobs equals the non-streaming response's list
        want_lp = bool(req.get("logprobs"))
        lp_n = (max(1, min(int(req.get("top_logprobs") or 1), LOGPROB_K))
                if want_lp else 0)

        # Resolve the token source BEFORE sending headers so protocol-level
        # failures still produce a clean HTTP 400.
        text_override: Optional[str] = None
        tok_queue: Optional[Any] = None
        wait = None
        if enum is not None:
            text_override = self._constrained_choice(prompt, *enum, images=images)
        else:
            ids, pix = self._prepare_ids(prompt, images)
            tok_queue = _queue.Queue()
            wait = self._start_generation(ids, pix, max_new, temperature,
                                          top_p, top_k, seed,
                                          logprobs=lp_n,
                                          on_token=tok_queue.put)
            if wait.future is not None:
                # all on_token calls happen before the result is set, so
                # the sentinel always trails the last token
                wait.future.add_done_callback(
                    lambda f: tok_queue.put(None))
            else:
                tok_queue = None   # bare engine: wait() replays post-hoc
                lp_n = 0           # bare engines have no logprob records

        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()

        def sse(obj) -> None:
            handler.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            handler.wfile.flush()

        def chunk(delta: Dict[str, Any], finish: Optional[str] = None):
            return {"id": rid, "object": "chat.completion.chunk",
                    "created": created, "model": model,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}]}

        def fmt_rec(rec) -> Dict[str, Any]:
            tok, lp, top = rec
            return {"token": self.tokenizer.decode([tok]), "logprob": lp,
                    "bytes": None,
                    "top_logprobs": [
                        {"token": self.tokenizer.decode([tid]),
                         "logprob": tlp} for tid, tlp in top[:lp_n]]}

        try:
            sse(chunk({"role": "assistant", "content": ""}))
            finish = "stop"
            prev = ""
            if tok_queue is not None:
                out: List[int] = []
                pending: List[Any] = []   # logprob records not yet emitted
                n_rec = 0                 # records emitted so far
                while True:
                    item = tok_queue.get(timeout=self.request_timeout)
                    if item is None:
                        break
                    if lp_n:
                        tok = item[0]
                        pending.append(item)
                    else:
                        tok = item
                    out.append(tok)
                    # incremental detokenization by whole-prefix diff: a
                    # token may not be a complete decodable unit (BPE /
                    # byte tokenizers), so hold back a trailing
                    # replacement char (the partial-sequence marker - the
                    # HF TextStreamer convention) and emit only clean
                    # extensions; sent text can never be retracted
                    text = self.tokenizer.decode(out)
                    if text.endswith("�"):
                        text = text[:-1]
                    if text[: len(prev)] == prev and len(text) > len(prev):
                        ck = chunk({"content": text[len(prev):]})
                        if lp_n:
                            ck["choices"][0]["logprobs"] = {
                                "content": [fmt_rec(r) for r in pending]}
                            n_rec += len(pending)
                            pending = []
                        sse(ck)
                        prev = text
                out, lps, tops = wait()  # re-raises scheduler-side failures
                # final flush: whatever the full decode holds past the
                # emitted length (covers decodes whose tail was unstable -
                # sent text cannot be retracted, so emit the remainder),
                # plus any logprob records not yet delivered
                full = self.tokenizer.decode(out)
                tail_recs = (list(zip(out, lps, tops))[n_rec:]
                             if lp_n else [])
                if len(full) > len(prev) or tail_recs:
                    ck = chunk({"content": full[len(prev):]})
                    if lp_n:
                        ck["choices"][0]["logprobs"] = {
                            "content": [fmt_rec(r) for r in tail_recs]}
                    sse(ck)
                finish = "stop" if len(out) < max_new else "length"
            elif text_override is not None:
                if text_override:
                    sse(chunk({"content": text_override}))
            else:
                out, _, _ = wait()
                text = self.tokenizer.decode(out)
                finish = "stop" if len(out) < max_new else "length"
                if text:
                    sse(chunk({"content": text}))
            sse(chunk({}, finish))
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        except Exception as e:  # noqa: BLE001 - post-header failure
            try:
                sse({"error": {"message": str(e),
                               "type": type(e).__name__}})
            except Exception:  # noqa: BLE001 - consumer already gone
                pass

    def _complete(self, req: Dict[str, Any]) -> Dict[str, Any]:
        max_new, temperature, top_p, top_k, seed = self._parse_sampling(req)
        prompt, images = extract_chat_content(req.get("messages", []))
        self._note_images(req, images)
        ids = self._encode(prompt, add_special_tokens=True)  # usage default
        # OpenAI logprobs surface: per-token logprob + top-N alternatives,
        # served through the batcher submit payload; bare engines degrade
        # gracefully (field omitted), like other optional params.
        want_lp = bool(req.get("logprobs"))
        lp_n = (max(1, min(int(req.get("top_logprobs") or 1), LOGPROB_K))
                if want_lp else 0)
        lps = tops = None
        enum = self._schema_enum(req)
        if enum is not None:
            text = self._constrained_choice(prompt, *enum, images=images)
            out = self._encode(text)
            finish = "stop"  # constrained decoding always completes
        else:
            ids, pix = self._prepare_ids(prompt, images)
            out, lps, tops = self._start_generation(
                ids, pix, max_new, temperature, top_p, top_k, seed,
                logprobs=lp_n)()
            text = self.tokenizer.decode(out)
            finish = "stop" if len(out) < max_new else "length"
        choice: Dict[str, Any] = {
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish,
        }
        if lps is not None:
            choice["logprobs"] = {"content": [
                {"token": self.tokenizer.decode([tok]), "logprob": lp,
                 "bytes": None,
                 "top_logprobs": [
                     {"token": self.tokenizer.decode([tid]), "logprob": tlp}
                     for tid, tlp in top]}
                for tok, lp, top in zip(out, lps, tops)
            ]}
        return {
            "id": f"chatcmpl-{int(time.time() * 1e3)}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": req.get("model", self.model_name),
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(ids),
                "completion_tokens": len(out),
                "total_tokens": len(ids) + len(out),
            },
        }


    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "GenerationServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "GenerationServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
