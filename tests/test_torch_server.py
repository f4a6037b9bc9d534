"""The port's OpenAI server on a tiny engine, against the JAX package's, on
the CPU: completions, SSE streaming, the enum ``response_format``, logprobs,
429/504 back-pressure, ``/health`` and image content to a text engine. Both
servers answer the same greedy request with the same text
(``tests/test_torch_paligemma.py`` serves images to an image engine).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import GemmaDecodeEngine as JEngine
from multimodal_colpali_tpu.generation.engine import ModuloTokenizer as JModTok
from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged
from multimodal_colpali_tpu.generation.server import GenerationServer as JServer
from multimodal_colpali_tpu.models.configs import Gemma3TextConfig as JG3
from multimodal_colpali_tpu.models.registry import gemma3_random_params
from multimodal_colpali_tpu_torch import serve
from multimodal_colpali_tpu_torch.generation import (
    ContinuousBatcher, GemmaDecodeEngine, GenerationServer, ModuloTokenizer,
    PagedContinuousBatcher)
from multimodal_colpali_tpu_torch.models.configs import Gemma3TextConfig
from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax

torch.set_num_threads(1)

MCQ = {"type": "json_schema", "json_schema": {"name": "mcq", "schema": {
    "type": "object", "properties": {"answer": {"type": "string",
                                                "enum": ["A", "B", "C", "D"]}}}}}


@pytest.fixture(scope="module")
def engines():
    params = jax.tree.map(np.asarray, gemma3_random_params(JG3.tiny(vocab_size=64), seed=2))
    jeng = JEngine(JG3.tiny(vocab_size=64), jax.tree.map(jnp.asarray, params))
    teng = GemmaDecodeEngine(Gemma3TextConfig.tiny(vocab_size=64),
                             engine_params_from_jax(params, device="cpu"), device="cpu")
    return jeng, teng


def _post(base_url, body, timeout=120):
    req = urllib.request.Request(base_url + "/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _body(content, **kw):
    return {"model": "tiny", "messages": [{"role": "user", "content": content}], **kw}


def _sse_events(resp):
    events = [line[len(b"data: "):] for line in resp.read().split(b"\n\n") if line]
    assert events[-1] == b"[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_completion_and_enum_match_jax_server(engines):
    """The same greedy chat request and the same MCQ request get the same
    answer from the port's server and the JAX package's."""
    jeng, teng = engines
    jb = JPaged(jeng, batch_slots=2, max_seq_len=96, chunk=4, page_size=8).serve()
    tb = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=96, chunk=4,
                                page_size=8).serve()
    reqs = [_body("What binds selectins?", max_tokens=6, seed=0),
            _body("Which option? A) x B) y C) z D) w", response_format=MCQ)]
    try:
        with JServer(jb, JModTok(64)) as js, GenerationServer(tb, ModuloTokenizer(64)) as ts:
            for body in reqs:
                want = json.loads(_post(js.base_url, body).read())
                got = json.loads(_post(ts.base_url, body).read())
                assert got["choices"][0]["message"] == want["choices"][0]["message"]
                assert got["choices"][0]["finish_reason"] == want["choices"][0]["finish_reason"]
                assert got["usage"] == want["usage"]
            answer = json.loads(got["choices"][0]["message"]["content"])["answer"]
            assert answer in ("A", "B", "C", "D")
    finally:
        jb.shutdown()
        tb.shutdown()


def test_sse_stream_equals_non_streaming(engines):
    _, teng = engines
    bat = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=96, chunk=2,
                                 page_size=8).serve()
    try:
        with GenerationServer(bat, ModuloTokenizer(64)) as srv:
            body = _body("stream me", max_tokens=7, seed=0)
            full = json.loads(_post(srv.base_url, body).read())["choices"][0]
            events = _sse_events(_post(srv.base_url, dict(body, stream=True)))
            assert events[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
            text = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
            assert text == full["message"]["content"]
            assert events[-1]["choices"][0]["finish_reason"] == full["finish_reason"] == "length"
            enum_events = _sse_events(_post(srv.base_url, _body("pick", stream=True,
                                                                response_format=MCQ)))
            picked = json.loads("".join(e["choices"][0]["delta"].get("content", "")
                                        for e in enum_events))
            assert picked["answer"] in ("A", "B", "C", "D")
    finally:
        bat.shutdown()


def test_logprobs_surface(engines):
    _, teng = engines
    bat = ContinuousBatcher(teng, batch_slots=2, max_seq_len=96, chunk=3).serve()
    try:
        with GenerationServer(bat, ModuloTokenizer(64)) as srv:
            out = json.loads(_post(srv.base_url, _body("lp", max_tokens=5, logprobs=True,
                                                       top_logprobs=2)).read())
        recs = out["choices"][0]["logprobs"]["content"]
        assert len(recs) == 5 and all(len(r["top_logprobs"]) == 2 for r in recs)
        assert all(r["logprob"] <= 0 for r in recs)
        assert " ".join(r["token"] for r in recs) == out["choices"][0]["message"]["content"]
    finally:
        bat.shutdown()


def test_bare_engine_server_and_health(engines):
    _, teng = engines
    with GenerationServer(teng, ModuloTokenizer(64)) as srv:
        health = urllib.request.urlopen(srv.base_url.removesuffix("/v1") + "/health",
                                        timeout=30)
        assert json.loads(health.read()) == {"status": "ok"}
        body = _body("bare", max_tokens=4, seed=0)
        out = json.loads(_post(srv.base_url, body).read())["choices"][0]["message"]["content"]
        ids = ModuloTokenizer(64).encode("user: bare\nassistant:", add_special_tokens=True)
        assert out == " ".join(map(str, teng.generate([ids], max_new_tokens=4)[0]))
        events = _sse_events(_post(srv.base_url, dict(body, stream=True)))
        assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) == out


def test_image_content_to_a_text_engine_is_answered_as_in_jax(engines):
    """An ``image_url`` part is no HTTP 400: a server without an image
    engine answers from the text, as the JAX server does (a part that does
    not decode is skipped, a PNG decodes and goes unused), with the same
    reply."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (30, 60, 90)).save(buf, format="PNG")
    png = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    body = {"model": "t", "max_tokens": 4, "messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is on this page?"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}},
        {"type": "image_url", "image_url": {"url": png}}]}]}
    jeng, teng = engines
    with JServer(jeng, JModTok(64)) as srv:
        want = json.loads(_post(srv.base_url, body).read())["choices"][0]["message"]
    with GenerationServer(teng, ModuloTokenizer(64)) as srv:
        resp = _post(srv.base_url, body)
        assert resp.status == 200
        assert json.loads(resp.read())["choices"][0]["message"] == want


def test_back_pressure_429_and_504(engines):
    """A submit past ``max_queue`` answers 429 at once; a request that
    outlives ``admission_timeout`` in the queue answers 504."""
    _, teng = engines
    bat = ContinuousBatcher(teng, batch_slots=1, max_seq_len=64, chunk=2, max_queue=1,
                            admission_timeout=0.05)   # not serving: the queue only fills
    codes = []

    def fire(content):
        try:
            codes.append(_post(srv.base_url, _body(content, max_tokens=3)).status)
        except urllib.error.HTTPError as e:
            codes.append((e.code, json.loads(e.read())["error"]["type"]))

    with GenerationServer(bat, ModuloTokenizer(64)) as srv:
        waiting = threading.Thread(target=fire, args=("first",))
        waiting.start()
        deadline = time.monotonic() + 30
        while bat._queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        fire("second")                      # the queue is at its bound
        assert codes == [(429, "AdmissionQueueFull")] and bat.rejected == 1
        time.sleep(0.1)                     # the first outlives the deadline
        bat.drain()
        waiting.join(30)
    assert codes[1] == (504, "TimeoutError") and bat.expired == 1


@pytest.mark.parametrize("model", ["tiny-gemma3", "tiny-colpali"])
def test_serve_cli_builds_a_servable_engine(model):
    args = serve.parse_args(["--model", model, "--device", "cpu", "--dtype", "float32",
                             "--paged", "--weight-dtype", "int8"])
    assert args.kv_dtype == "native" and args.page_size == 16
    eng, tok, _, _ = serve.build(args)
    assert eng.device.type == "cpu" and eng.weight_dtype == "int8"
    assert isinstance(tok, ModuloTokenizer) or hasattr(tok, "decode")
    out = eng.generate([tok.encode("hello")], max_new_tokens=3)
    assert len(out[0]) == 3


def test_sse_logprobs_equal_the_non_streaming_records(engines):
    """Streamed chunks carry the logprob records of the tokens they deliver;
    joined, they equal the non-streaming response's list."""
    _, teng = engines
    bat = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=96, chunk=2,
                                 page_size=8).serve()
    try:
        with GenerationServer(bat, ModuloTokenizer(64)) as srv:
            body = _body("stream lp", max_tokens=6, seed=0, logprobs=True, top_logprobs=3)
            want = json.loads(_post(srv.base_url, body).read())["choices"][0]["logprobs"]
            events = _sse_events(_post(srv.base_url, dict(body, stream=True)))
        got = [rec for e in events
               for rec in (e["choices"][0].get("logprobs") or {}).get("content", [])]
        assert len(got) == 6 and got == want["content"]
    finally:
        bat.shutdown()
