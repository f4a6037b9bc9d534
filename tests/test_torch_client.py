"""The port's HTTP client (``generation/client``, on the standard library)
against the JAX package's (on aiohttp), on the CPU: the same replies, request
bodies, headers and backoff delays against ``tests/fake_openai`` and against a
server scripted to answer each case of the reference's retry semantics; the
connection cap; ``run_sync`` inside a running loop; both clients through a
tiny ``GenerationServer`` of each package; the constrained forwards the port's
server runs one at a time (fault F4); and the GPU host's package set, where
the client, the api, the server and chip_smoke import with no aiohttp, httpx,
pandas, Pillow or JAX.
"""

import asyncio
import json
import subprocess
import sys
import textwrap
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_colpali_tpu.generation.client as jclient
import multimodal_colpali_tpu_torch.generation.client as tclient
from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.generation.engine import ModuloTokenizer as JModTok
from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged
from multimodal_colpali_tpu.generation.server import GenerationServer as JServer
from multimodal_colpali_tpu.models.configs import Gemma3TextConfig as JG3
from multimodal_colpali_tpu.models.registry import gemma3_random_params
from multimodal_colpali_tpu_torch.generation import (
    GemmaDecodeEngine, GenerationServer, ModuloTokenizer, PagedContinuousBatcher)
from multimodal_colpali_tpu_torch.generation.parse import identity_perm, response_real_out
from multimodal_colpali_tpu_torch.models.configs import Gemma3TextConfig
from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax
from tests.fake_openai import FakeOpenAIServer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CLOSED = "http://127.0.0.1:9/v1/chat/completions"   # the discard port: refused


class Scripted:
    """A chat-completions server whose reply to each POST is
    ``reply(n, body) -> (status, content type or None, body bytes)``; it
    records each request's raw body and headers, the requests in flight at
    once (``peak``), and can hold each request at a barrier of ``barrier``
    parties or for ``delay`` seconds."""

    def __init__(self, reply, delay: float = 0.0, barrier: int = 0):
        self.reply, self.delay = reply, delay
        self.bodies, self.headers = [], []
        self.in_flight = self.peak = 0
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(barrier, timeout=10) if barrier else None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with outer._lock:
                    n = len(outer.bodies)
                    outer.bodies.append(raw)
                    outer.headers.append({k: self.headers.get(k)
                                          for k in ("Authorization", "Content-Type")})
                    outer.in_flight += 1
                    outer.peak = max(outer.peak, outer.in_flight)
                try:
                    if outer._barrier is not None:
                        outer._barrier.wait()
                    time.sleep(outer.delay)
                finally:
                    with outer._lock:
                        outer.in_flight -= 1
                status, ctype, data = outer.reply(n, json.loads(raw))
                self.send_response(status)
                if ctype is not None:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128

        self._server = Server(("127.0.0.1", 0), Handler)
        self.base_url = f"http://127.0.0.1:{self._server.server_port}/v1"
        self.url = self.base_url + "/chat/completions"

    def __enter__(self):
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *a):
        self._server.shutdown()
        self._server.server_close()


def completion(content) -> bytes:
    return json.dumps({"choices": [{"index": 0, "message": {"role": "assistant",
                                                             "content": content}}]}).encode()


def echo(n, body):
    """Reply with the last user message, reversed, and the request's index."""
    text = body["messages"][-1]["content"]
    text = text if isinstance(text, str) else json.dumps(text)
    return 200, "application/json", completion(f"{text[::-1]}#{len(body)}")


class _RecordingAsyncio:
    """A client module's ``asyncio`` with ``sleep`` recording its delay."""

    def __init__(self, delays):
        self.delays = delays

    def __getattr__(self, name):
        return getattr(asyncio, name)

    async def sleep(self, delay):
        self.delays.append(delay)


@pytest.fixture
def delays(monkeypatch):
    """Each package's client sleeps recorded, not slept: {"jax": [...], "port": [...]}."""
    out = {"jax": [], "port": []}
    monkeypatch.setattr(jclient, "asyncio", _RecordingAsyncio(out["jax"]))
    monkeypatch.setattr(tclient, "asyncio", _RecordingAsyncio(out["port"]))
    return out


def prompts(n=5):
    return [[{"role": "user", "content": f"question {i}: which glycan binds? " + "x" * i}]
            for i in range(n)]


# -- the same requests, the same replies ----------------------------------------------------


def _call(client, which, base_url, msgs):
    if which == "get_responses":
        return client.get_responses("tiny", 0, msgs, base_url=base_url,
                                    extra_body={"max_tokens": 3, "seed": 1})
    url, headers = client.resolve_endpoint("tiny", base_url=base_url)
    if which == "run_inference":
        return client.run_inference("tiny", msgs, url, headers, use_schema=True)
    return client.get_response_context("What binds? ", msgs, "tiny", url, headers)


@pytest.mark.parametrize("which", ["get_responses", "run_inference", "get_response_context"])
def test_outputs_bodies_and_headers_equal_jax(which, monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    msgs = prompts()
    seen = {}
    for name, client in (("jax", jclient), ("port", tclient)):
        with FakeOpenAIServer(lambda req: json.dumps(req["messages"])[:40]) as fake:
            out = client.run_sync(_call(client, which, fake.base_url, msgs))
            reqs = list(fake.requests)
        with Scripted(echo) as srv:
            out2 = client.run_sync(_call(client, which, srv.base_url, msgs))
        seen[name] = (out, sorted(json.dumps(r, sort_keys=True) for r in reqs), out2,
                      sorted(srv.bodies),
                      sorted(json.dumps(h, sort_keys=True) for h in srv.headers))
    assert seen["port"] == seen["jax"]
    out, _, _, bodies, headers = seen["port"]
    assert all(isinstance(o, str) and o != tclient.ERROR_SENTINEL
               for o in (out if isinstance(out, list) else [out]))
    assert json.loads(headers[0]) == {"Authorization": "Bearer sk-test",
                                      "Content-Type": "application/json"}
    if which == "run_inference":
        assert all(json.loads(b)["response_format"] == tclient.mcq_response_format()
                   for b in bodies)


def test_resolve_endpoint_and_schema_equal_jax(monkeypatch):
    monkeypatch.delenv("OPENAI_BASE_URL", raising=False)
    monkeypatch.setenv("OPENAI_API_KEY", "sk-o")
    monkeypatch.setenv("VLLM_API_KEY", "v")
    for args in (("gpt-5",), ("google/gemma-3-27b-it", 8006), ("m", 1, "http://h:2/v1/")):
        assert tclient.resolve_endpoint(*args) == jclient.resolve_endpoint(*args)
    monkeypatch.setenv("OPENAI_BASE_URL", "http://env:3/v1")
    assert tclient.resolve_endpoint("gpt-5") == jclient.resolve_endpoint("gpt-5")
    assert tclient.mcq_response_format() == jclient.mcq_response_format()
    assert tclient.ERROR_SENTINEL == jclient.ERROR_SENTINEL


# -- the reference's semantics, case by case (client.py:22-46) --------------------------------

JSON = "application/json"
CASES = {
    # name: (status, content type, body) -> what both clients do
    "ok": (200, JSON, completion("B")),
    "ok_charset": (200, "application/json; charset=utf-8", completion("é")),
    "ok_vendor_json": (200, "application/vnd.api+json", completion("C")),
    "content_not_a_string": (200, JSON, completion(5)),
    "no_choices_key": (200, JSON, b'{"id": "x"}'),
    "other_mimetype": (200, "text/plain", completion("A")),
    "no_content_type": (200, None, completion("A")),
    "empty_body": (200, JSON, b""),
    "invalid_json": (200, JSON, b"{not json"),
    "empty_choices": (200, JSON, b'{"choices": []}'),
    "json_list": (200, JSON, b"[]"),
    "status_500": (500, JSON, completion("A")),
    "status_404": (404, None, b""),
    "status_429": (429, JSON, b'{"error": {}}'),
    "status_201": (201, JSON, completion("A")),
}


def _outcome(coro_fn):
    try:
        return ("value", asyncio.run(coro_fn()))
    except Exception as e:  # noqa: BLE001 - the outcome under test
        cause = e.__cause__
        return ("raise", type(e).__name__, str(e) if isinstance(e, RuntimeError) else None,
                None if cause is None else
                isinstance(cause, (aiohttp.ClientError, tclient.ClientError, TimeoutError)))


def _jax_post(fn, url, timeout=None, **kw):
    async def go():
        t = aiohttp.ClientTimeout(total=timeout) if timeout else aiohttp.ClientTimeout(total=300)
        async with aiohttp.ClientSession(timeout=t) as s:
            return await fn(s, url, {"Content-Type": JSON}, {"model": "m", "messages": []}, **kw)
    return go


def _port_post(fn, url, timeout=None, **kw):
    async def go():
        async with tclient.ClientSession(limit=100) as s:
            return await fn(s, url, {"Content-Type": JSON}, {"model": "m", "messages": []}, **kw)
    return go


def _both(variant, reply, delays, url=None, timeout=None, delay=0.0, **kw):
    """-> {pkg: (outcome, requests seen, delays)} for one reply script; a
    ``timeout`` replaces each client's 300 s total."""
    out = {}
    for pkg, client, post in (("jax", jclient, _jax_post), ("port", tclient, _port_post)):
        fn = getattr(client, variant)
        with Scripted(reply, delay=delay) as srv, pytest.MonkeyPatch.context() as mp:
            if timeout:
                mp.setattr(tclient, "TOTAL_TIMEOUT_S", timeout)
            res = _outcome(post(fn, url or srv.url, timeout=timeout, retries=3, backoff=0.25,
                                **kw))
            out[pkg] = (res, 0 if url else len(srv.bodies), list(delays[pkg]))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("variant", ["post_request_with_retries",
                                     "post_request_with_retries_raising"])
def test_semantics_table(case, variant, delays):
    reply = CASES[case]
    got = _both(variant, lambda n, body: reply, delays)
    assert got["port"] == got["jax"], got
    outcome, n_requests, waits = got["port"]
    retried = {"other_mimetype", "no_content_type", "status_500", "status_404", "status_429"}
    if variant == "post_request_with_retries":
        retried |= {"status_201"}      # only 200 is read
        want = {"ok": ("value", "B"), "ok_charset": ("value", "é"),
                "ok_vendor_json": ("value", "C"),
                "content_not_a_string": ("value", tclient.ERROR_SENTINEL),
                "no_choices_key": ("value", tclient.ERROR_SENTINEL),
                "empty_body": ("raise", "AttributeError"),
                "json_list": ("raise", "AttributeError"),
                "invalid_json": ("raise", "JSONDecodeError"),
                "empty_choices": ("raise", "IndexError")}
        want.update({c: ("value", tclient.ERROR_SENTINEL) for c in retried})
    else:
        want = {"ok": ("value", "B"), "ok_charset": ("value", "é"),
                "ok_vendor_json": ("value", "C"), "status_201": ("value", "A"),
                "content_not_a_string": ("value", 5),
                "no_choices_key": ("raise", "KeyError"),
                "empty_body": ("raise", "TypeError"), "json_list": ("raise", "TypeError"),
                "invalid_json": ("raise", "JSONDecodeError"),
                "empty_choices": ("raise", "IndexError")}
        want.update({c: ("raise", "RuntimeError") for c in retried})
    assert outcome[:len(want[case])] == want[case]
    if case in retried:
        assert n_requests == 3 and waits == [0.25, 0.5]
        if variant == "post_request_with_retries_raising":
            assert outcome[2] == "request failed after 3 retries" and outcome[3] is True
    else:
        assert n_requests == 1 and waits == []


@pytest.mark.parametrize("variant", ["post_request_with_retries",
                                     "post_request_with_retries_raising"])
def test_refused_connection_and_timeout_are_retried(variant, delays):
    refused = _both(variant, None, delays, url=CLOSED)
    assert refused["port"] == refused["jax"]
    for pkg in ("jax", "port"):
        delays[pkg].clear()
    slow = _both(variant, lambda n, body: (200, JSON, completion("late")), delays,
                 timeout=0.3, delay=1.0)
    assert slow["port"][0] == slow["jax"][0]
    for got in (refused, slow):
        outcome, _, waits = got["port"]
        assert waits == [0.25, 0.5]
        assert outcome[:2] == (("value", tclient.ERROR_SENTINEL)
                               if variant == "post_request_with_retries"
                               else ("raise", "RuntimeError"))
    assert slow["port"][1] == slow["jax"][1] == 3


class _Py310Asyncio(_RecordingAsyncio):
    """A client module's ``asyncio`` whose ``TimeoutError`` is not the
    builtin one, as on Python 3.10."""

    class TimeoutError(Exception):  # noqa: A001 - asyncio's own name
        pass


@pytest.mark.parametrize("variant", ["post_request_with_retries",
                                     "post_request_with_retries_raising"])
def test_a_socket_timeout_raises_asyncio_s_timeout_error(variant, monkeypatch):
    """A read timeout and a spent deadline raise ``asyncio.TimeoutError``
    itself, so the retry loops catch it where it is not the builtin."""
    waits = []
    monkeypatch.setattr(tclient, "asyncio", _Py310Asyncio(waits))

    class Session:   # the blocking post alone, no wait_for around it
        async def post(self, url, headers, data):
            return tclient._post_blocking(url, headers, json.dumps(data).encode(),
                                          time.monotonic() + 0.2)

    with Scripted(lambda n, body: (200, JSON, completion("late")), delay=1.0) as srv:
        with pytest.raises(_Py310Asyncio.TimeoutError) as read:
            tclient._post_blocking(srv.url, {}, b"{}", time.monotonic() + 0.2)
        assert type(read.value) is _Py310Asyncio.TimeoutError
        assert isinstance(read.value.__cause__, TimeoutError)
        with pytest.raises(_Py310Asyncio.TimeoutError):
            tclient._post_blocking(srv.url, {}, b"{}", time.monotonic() - 1.0)
        outcome = _outcome(lambda: getattr(tclient, variant)(
            Session(), srv.url, {}, {"model": "m"}, retries=2, backoff=0.25))
    assert waits == [0.25]
    assert outcome[:2] == (("value", tclient.ERROR_SENTINEL)
                           if variant == "post_request_with_retries"
                           else ("raise", "RuntimeError"))


def test_backoff_sequence_and_sentinel_through_get_responses(delays):
    """The default path: 5 attempts, 1 s doubling (15 s of sleep, recorded
    instead), then the sentinel; a server that fails twice then answers."""
    for pkg, client in (("jax", jclient), ("port", tclient)):
        with Scripted(lambda n, body: (503, None, b"")) as srv:
            out = client.run_sync(client.get_responses("m", 0, prompts(1), base_url=srv.base_url))
            assert out == [client.ERROR_SENTINEL] and len(srv.bodies) == 5
        with FakeOpenAIServer() as fake:
            fake.fail_next = 2
            assert client.run_sync(client.get_responses("m", 0, prompts(1),
                                                        base_url=fake.base_url)) == ["A"]
    assert delays["port"] == delays["jax"] == [1.0, 2.0, 4.0, 8.0, 1.0, 2.0]


@pytest.mark.parametrize("limit", [1, 3])
def test_connector_limit_caps_requests_in_flight(limit):
    """With 12 prompts and ``connector_limit`` N, the fake sees exactly N at
    once: its barrier of N parties only opens when N are in flight."""
    for client in (jclient, tclient):
        with Scripted(echo, barrier=limit, delay=0.05) as srv:
            out = client.run_sync(client.get_responses("m", 0, prompts(12), base_url=srv.base_url,
                                                       connector_limit=limit))
        assert client.ERROR_SENTINEL not in out and len(srv.bodies) == 12
        assert srv.peak == limit, (client.__name__, srv.peak)


def test_session_runs_past_the_default_executor_cap():
    """64 requests held at one barrier all get through: the session's own pool
    is not the loop's default executor (min(32, cpus + 4) threads)."""
    with Scripted(echo, barrier=64) as srv:
        out = tclient.run_sync(tclient.get_responses("m", 0, prompts(64), base_url=srv.base_url))
    assert tclient.ERROR_SENTINEL not in out and srv.peak == 64


def test_run_sync_inside_a_running_loop():
    with FakeOpenAIServer(lambda req: "D") as fake:
        async def outer():
            return tclient.run_sync(tclient.get_responses("m", 0, prompts(3),
                                                          base_url=fake.base_url))
        assert asyncio.run(outer()) == ["D"] * 3
    assert tclient.run_sync(asyncio.sleep(0, result=7)) == 7


def test_session_post_outside_its_context_raises():
    with pytest.raises(RuntimeError, match="async with"):
        asyncio.run(tclient.ClientSession(limit=1).post(CLOSED, {}, {}))


# -- through a tiny GenerationServer of each package ------------------------------------------

MCQ_PROMPTS = [[{"role": "user", "content": f"Q{i}: which lectin? A) a B) b C) c D) d"}]
               for i in range(16)]


@pytest.fixture(scope="module")
def engines():
    params = jax.tree.map(np.asarray, gemma3_random_params(JG3.tiny(vocab_size=64), seed=2))
    jeng = JEngine(JG3.tiny(vocab_size=64), jax.tree.map(jnp.asarray, params))
    teng = GemmaDecodeEngine(Gemma3TextConfig.tiny(vocab_size=64),
                             engine_params_from_jax(params, device="cpu"), device="cpu")
    return jeng, teng


def test_both_clients_through_both_servers(engines):
    jeng, teng = engines
    jb = JPaged(jeng, batch_slots=2, max_seq_len=96, chunk=4, page_size=8).serve()
    tb = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=96, chunk=4,
                                page_size=8).serve()
    msgs = prompts(4)
    got = []
    try:
        with JServer(jb, JModTok(64)) as js, GenerationServer(tb, ModuloTokenizer(64)) as ts:
            for srv in (js, ts):
                url, headers = tclient.resolve_endpoint("tiny", base_url=srv.base_url)
                for client in (jclient, tclient):
                    free = client.run_sync(client.get_responses(
                        "tiny", 0, msgs, base_url=srv.base_url, extra_body={"max_tokens": 4}))
                    mcq = client.run_sync(client.run_inference(
                        "tiny", MCQ_PROMPTS[:4], url, headers, use_schema=True))
                    got.append((free, mcq))
    finally:
        jb.shutdown()
        tb.shutdown()
    assert all(g == got[0] for g in got)
    free, mcq = got[0]
    assert all(len(t.split()) == 4 for t in free)
    assert all(response_real_out(r, identity_perm()) == (json.loads(r)["answer"],) * 2
               for r in mcq)


def _count_forwards(engine, record, hold: float = 0.05):
    """Wrap ``engine.next_token_logits`` to record the calls in flight."""
    inner, lock = engine.next_token_logits, threading.Lock()
    state = {"now": 0}

    def wrapped(*a, **kw):
        with lock:
            state["now"] += 1
            record.append(state["now"])
        try:
            time.sleep(hold)
            return inner(*a, **kw)
        finally:
            with lock:
                state["now"] -= 1
    engine.next_token_logits = wrapped
    return inner


def test_constrained_forwards_run_one_at_a_time(engines):
    """F4: 16 constrained requests at once. The JAX server runs their
    prefills all at once (each with dense caches of its own); the port's runs
    one at a time, and the answers are the JAX server's."""
    jeng, teng = engines
    jb = JPaged(jeng, batch_slots=2, max_seq_len=96, chunk=4, page_size=8).serve()
    tb = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=96, chunk=4,
                                page_size=8).serve()
    seen = {"jax": [], "port": []}
    originals = (_count_forwards(jeng, seen["jax"]), _count_forwards(teng, seen["port"]))
    try:
        with JServer(jb, JModTok(64)) as js, GenerationServer(tb, ModuloTokenizer(64)) as ts:
            answers = [tclient.run_sync(tclient.run_inference(
                "tiny", MCQ_PROMPTS, *tclient.resolve_endpoint("tiny", base_url=s.base_url),
                use_schema=True)) for s in (js, ts)]
    finally:
        jeng.next_token_logits, teng.next_token_logits = originals
        jb.shutdown()
        tb.shutdown()
    assert len(seen["jax"]) == len(seen["port"]) == 16
    assert max(seen["port"]) == 1
    assert max(seen["jax"]) > 1          # the fault, as the JAX server has it
    assert answers[0] == answers[1]
    assert {json.loads(a)["answer"] for a in answers[1]} <= set("ABCD")


# -- the GPU host's package set ---------------------------------------------------------------

CARD_SET = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"jax", "jaxlib", "flax", "multimodal_colpali_tpu", "aiohttp", "httpx",
               "pandas", "PIL", "transformers", "safetensors", "tokenizers", "matplotlib"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"No module named {name!r}", name=name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    import json
    import torch
    import chip_smoke  # noqa: F401
    import multimodal_colpali_tpu_torch
    from multimodal_colpali_tpu_torch import api, config, serve  # noqa: F401
    from multimodal_colpali_tpu_torch.utils import health, housekeeping, userops  # noqa: F401
    from multimodal_colpali_tpu_torch.generation import (
        GemmaDecodeEngine, GenerationServer, ModuloTokenizer, PagedContinuousBatcher,
        get_responses, resolve_endpoint, run_inference, run_sync)
    from multimodal_colpali_tpu_torch.models.registry import load_gemma3_lm
    from multimodal_colpali_tpu_torch.ingest import (  # noqa: F401
        annotate, chunker, imageops, ocr, ocr_conv, pdf_loader, pdfwrite, pipeline,
        preprocess, rasterize, remote_parse, tables)
    from multimodal_colpali_tpu_torch.drivers import create_context  # noqa: F401
    from multimodal_colpali_tpu_torch.models import load_retriever

    # ingest's main path: a written PDF rasterized, resized (LANCZOS), through
    # the processor (BICUBIC) and embedded by create_document_embeddings
    import os, tempfile
    pdfs = tempfile.mkdtemp()
    pdfwrite.make_sample_pdf(os.path.join(pdfs, "p.pdf"), n_pages=1, lines_per_page=4)
    page = preprocess.resize_image(rasterize.PdfDocument(os.path.join(pdfs, "p.pdf")).render(0))
    assert page.shape == (1300, 1005, 3), page.shape
    retr = load_retriever("tiny-colpali", device="cpu", device_preprocess=True)
    batch = retr.processor.process_images([page], device_preprocess=True)
    assert batch["pixel_values"].shape == (1, 28, 28, 3)
    (entry,) = api.create_document_embeddings(pdfs, retr)
    assert entry["file_name"] == "p.pdf" and entry["embedding"].ndim == 2
    # the dynamic layouts' processors (anyres tiles, image splitting) and W8A8
    for name in ("tiny-colgranite", "tiny-colidefics3"):
        dyn = load_retriever(name, device="cpu", dynamic_resolution=True, quantize="int8")
        (emb,) = dyn.embed_images([page])
        assert emb.ndim == 2 and emb.shape[0] > 40, (name, emb.shape)
    # the old-model tier: Qwen2-VL and LLaVA-NeXT image requests through the
    # speculative paged batcher, their pages resized by the port's own code
    import warnings
    from multimodal_colpali_tpu_torch.generation import (
        LlamaDecodeEngine, LlavaNextImagePreprocessor, LlavaNextMMEngine, Qwen2DecodeEngine,
        Qwen2VLImagePreprocessor, Qwen2VLMMEngine, SpeculativePagedContinuousBatcher)
    from multimodal_colpali_tpu_torch.models import registry as R
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qcfg, qp, _ = R.load_qwen2vl_mm("tiny-qwen2vl", device="cpu", dtype=torch.float32)
        lcfg, lp, _ = R.load_llava_next_mm("tiny-llava-next", device="cpu",
                                           dtype=torch.float32)
    qlm = Qwen2DecodeEngine(qcfg.text, qp, dtype=torch.float32, device="cpu")
    llm = LlamaDecodeEngine(lcfg.text, lp, dtype=torch.float32, device="cpu")
    for lm, mm, pre in ((qlm, Qwen2VLMMEngine(qcfg, qp["visual"], qlm),
                         Qwen2VLImagePreprocessor(qcfg)),
                        (llm, LlavaNextMMEngine(lcfg, lp["vision_tower"],
                                                lp["multi_modal_projector"], llm),
                         LlavaNextImagePreprocessor(lcfg))):
        pix = pre([page])
        prompt = mm.build_mm_prompt([3, 5, 7])
        bat = SpeculativePagedContinuousBatcher(lm, batch_slots=2, max_seq_len=64, chunk=2,
                                                page_size=8, mm_engine=mm, spec_k=3)
        fut = bat.submit(prompt, max_new_tokens=5, pixel_values=pix[0])
        bat.drain()
        assert fut.result(30) == mm.generate([prompt], pix[None], max_new_tokens=5)[0]

    try:
        import multimodal_colpali_tpu_torch.evalstats  # noqa: F401
    except ImportError as e:
        assert "pandas" in str(e), e
    else:
        raise SystemExit("evalstats imported without pandas")
    cfg, params, _ = load_gemma3_lm("tiny-gemma3", device="cpu", dtype=torch.float32)
    engine = GemmaDecodeEngine(cfg, params, dtype=torch.float32, device="cpu")
    tok = ModuloTokenizer(cfg.vocab_size)
    bat = PagedContinuousBatcher(engine, batch_slots=2, max_seq_len=96, chunk=4,
                                 page_size=8).serve()
    srv = GenerationServer(bat, tok).start()
    try:
        assert health.check_vllm_status(srv.base_url.rsplit("/v1", 1)[0] + "/health")
        msgs = [[{"role": "user", "content": f"q{i}"}] for i in range(3)]
        free = run_sync(get_responses("tiny", 0, msgs, base_url=srv.base_url,
                                      extra_body={"max_tokens": 3}))
        mcq = run_sync(run_inference("tiny", msgs, *resolve_endpoint("tiny", base_url=srv.base_url),
                                     use_schema=True))
    finally:
        srv.stop()
        bat.shutdown()
    assert all(len(t.split()) == 3 for t in free), free
    assert all(json.loads(m)["answer"] in "ABCD" for m in mcq), mcq
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("CARD_SET_OK")
""")


def test_card_package_set_imports_and_serves(tmp_path):
    script = tmp_path / "card_set.py"
    script.write_text(CARD_SET)
    r = subprocess.run([sys.executable, str(script), str(REPO)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0 and "CARD_SET_OK" in r.stdout, r.stderr[-3000:]
