"""The port's ``utils`` and the four client functions of its ``api`` against
the JAX package's, on the CPU: ``health`` up, down and on a non-200 status,
``monitor_vllm_process``'s failure path, ``housekeeping`` on the CPU (with
``profile_to`` into a temporary directory), ``io``'s CSV fallback,
``userops`` with ``time.sleep`` and ``smtplib.SMTP`` patched (the same
messages and pickles), and ``get_img_summary`` / ``process_models`` /
``models_local`` / ``models_used`` with the same outputs."""

import asyncio
import json
import pickle
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import multimodal_colpali_tpu.api as japi
import multimodal_colpali_tpu.utils.health as jhealth
import multimodal_colpali_tpu.utils.io as jio
import multimodal_colpali_tpu.utils.userops as juserops
import multimodal_colpali_tpu_torch.api as tapi
import multimodal_colpali_tpu_torch.utils.health as thealth
import multimodal_colpali_tpu_torch.utils.io as tio
import multimodal_colpali_tpu_torch.utils.userops as tuserops
from multimodal_colpali_tpu.documents import Document as JDocument
from multimodal_colpali_tpu_torch.documents import Document as TDocument
from multimodal_colpali_tpu_torch.utils import housekeeping
from tests.fake_openai import FakeOpenAIServer

DOWN = "http://127.0.0.1:9"   # the discard port: refused


class Endpoint:
    """A server answering GET and POST with ``reply(n, method, path, body) ->
    (status, body bytes)`` (JSON); it records each request."""

    def __init__(self, reply):
        self.requests = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _answer(self, method):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
                outer.requests.append((method, self.path, self.headers.get("Authorization"),
                                       json.loads(raw) if raw else None))
                status, data = reply(len(outer.requests) - 1, method, self.path,
                                     outer.requests[-1][3])
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._answer("GET")

            def do_POST(self):
                self._answer("POST")

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.root = f"http://127.0.0.1:{self._server.server_port}"

    def __enter__(self):
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *a):
        self._server.shutdown()
        self._server.server_close()


# -- health -----------------------------------------------------------------------------------


@pytest.mark.parametrize("status", [200, 204, 301, 404, 503])
def test_health_up_down_and_status_equal_jax(status):
    with Endpoint(lambda n, m, p, b: (status, b"{}")) as ep:
        want = jhealth.check_vllm_status(ep.root + "/health")
        assert thealth.check_vllm_status(ep.root + "/health") is want is (status == 200)
    assert thealth.check_vllm_status(DOWN + "/health") is jhealth.check_vllm_status(
        DOWN + "/health") is False


def test_monitor_process_failure_and_success_paths(capsys):
    for mod in (jhealth, thealth):
        proc = subprocess.Popen([sys.executable, "-c", "import sys; print('boot'); sys.exit(3)"],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        ok, out, err = mod.monitor_vllm_process(proc, check_interval=0,
                                                health_url=DOWN + "/health", max_wait=5)
        assert not ok
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        with Endpoint(lambda n, m, p, b: (200, b"{}")) as ep:
            got = thealth.monitor_vllm_process(proc, check_interval=0,
                                               health_url=ep.root + "/health")
            assert got == jhealth.monitor_vllm_process(proc, check_interval=0,
                                                       health_url=ep.root + "/health")
        assert got == (True, "", "")
        assert thealth.monitor_vllm_process(proc, check_interval=0, health_url=DOWN,
                                            max_wait=0.01)[0] is False
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- housekeeping -----------------------------------------------------------------------------


def test_housekeeping_on_the_cpu(tmp_path, capsys):
    assert housekeeping.device_memory_stats() == {}
    assert housekeeping.device_memory_stats("cpu") == {}
    assert housekeeping.device_memory_stats(torch.device("cpu")) == {}
    assert housekeeping.get_less_used_device(debug=True) == 0
    assert housekeeping.get_less_used_device(["cpu", "cpu"]) == 0
    assert "Suggested device: 0" in capsys.readouterr().out
    assert housekeeping.live_arrays_bytes() == 0
    held = [torch.ones(128, 128), torch.zeros(3)]
    housekeeping.free_memory(held, debug=True)
    assert held == []
    with housekeeping.trace("unit"):
        _ = torch.zeros(4) + 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[trace] unit: ") and line.endswith(" ms")
    float(line.split(": ")[1][:-3])
    with housekeeping.trace("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""
    with housekeeping.profile_to(str(tmp_path / "prof")):
        with housekeeping.trace("inside", verbose=False):
            torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "inside" in names


# -- io ---------------------------------------------------------------------------------------


def test_io_csv_fallback_equal_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"Question_nr": np.arange(6), "Correct": rng.choice(list("ABCD"), 6),
                       "score": rng.normal(size=6), "Difficulty": ["Easy", "Hard"] * 3})
    outs = {}
    for name, mod in (("jax", jio), ("port", tio)):
        d = tmp_path / name
        outs[name] = [mod.write_table(df, str(d / "sub" / "table.xlsx")),
                      mod.write_table(df, str(d / "plain.csv"), index=True)]
        assert outs[name] == [str(d / "sub" / "table.csv"), str(d / "plain.csv")]
        assert f"wrote {d / 'sub' / 'table.csv'} instead of" in capsys.readouterr().out
        pd.testing.assert_frame_equal(mod.read_table(str(d / "sub" / "table.xlsx")), df)
        pd.testing.assert_frame_equal(mod.read_table(str(d / "sub" / "table.csv")), df)
        (d / "only.xlsx").write_bytes(b"PK")
        with pytest.raises(RuntimeError, match="no Excel engine"):
            mod.read_table(str(d / "only.xlsx"))
        with pytest.raises(FileNotFoundError):
            mod.read_table(str(d / "missing.xlsx"))
    for j, t in zip(outs["jax"], outs["port"]):
        with open(j, "rb") as a, open(t, "rb") as b:
            assert a.read() == b.read()


# -- userops ----------------------------------------------------------------------------------


class _RecordingTime:
    def __init__(self, delays):
        self.delays = delays

    def __getattr__(self, name):
        return getattr(time, name)

    def sleep(self, delay):
        self.delays.append(delay)


def _script(fail: int, broken: str):
    """A chat endpoint: the first ``fail`` replies are faults of kind
    ``broken`` (a 500 status, or a 200 without ``choices``), then a summary
    naming the request's index."""
    def reply(n, method, path, body):
        if n < fail:
            return (500, b"{}") if broken == "status" else (200, b'{"id": "x"}')
        return 200, json.dumps({"choices": [{"message": {"content": f"summary {n} " * 4}}]}
                               ).encode()
    return reply


@pytest.mark.parametrize("broken", ["status", "no_choices"])
def test_api_models_one_img_equal_jax(tmp_path, monkeypatch, broken):
    img = tmp_path / "x.jpg"
    img.write_bytes(b"\xff\xd8 not really a jpeg")
    got = {}
    for name, mod in (("jax", juserops), ("port", tuserops)):
        delays = []
        monkeypatch.setattr(mod, "time", _RecordingTime(delays))
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        with Endpoint(_script(3, broken)) as ep:
            models = [{"model_id": "org/model-with-a-long-name", "api_url": ep.root + "/v1/",
                       "api_key": "k"}, {"model_id": "m2", "api_url": ep.root + "/v1"}]
            out = mod.api_models_one_img([str(img), ""], ["", "some text"], models,
                                         "describe", "summarize: ", max_tokens=7,
                                         text_cutoff=20, base_backoff=2.0, max_backoff=5.0)
            reqs = ep.requests
        pkls = {p.name: pickle.loads(p.read_bytes()) for p in sorted(work.glob("*.pkl"))}
        got[name] = (out, reqs, delays, pkls)
    assert got["port"] == got["jax"]
    out, reqs, delays, pkls = got["port"]
    assert delays == [2.0, 4.0, 5.0]
    assert set(pkls) == {"model-with-a-lo.pkl", "m2.pkl"}
    assert [r[2] for r in reqs] == ["Bearer k"] * 5 + ["Bearer EMPTY"] * 2
    assert reqs[0][3]["messages"][0]["content"][1]["image_url"]["url"].startswith(
        "data:image/jpeg;base64,")
    assert all(len(o["output"]) == 20 for o in out)


def test_api_models_one_img_raises_after_its_retries(tmp_path, monkeypatch):
    for mod in (juserops, tuserops):
        delays = []
        monkeypatch.setattr(mod, "time", _RecordingTime(delays))
        monkeypatch.chdir(tmp_path)
        with Endpoint(_script(99, "status")) as ep:
            with pytest.raises(Exception) as info:
                mod.api_models_one_img([""], ["t"], [{"model_id": "m", "api_url": ep.root}],
                                       "d", "s: ", retries=3)
            assert len(ep.requests) == 3
        assert "500" in str(info.value)
        assert delays == [10.0, 20.0]
        with pytest.raises(Exception):
            mod.api_models_one_img([""], ["t"], [{"model_id": "m", "api_url": DOWN}],
                                   "d", "s: ", retries=2)


def test_send_password_email_equal_jax(monkeypatch):
    sent = []

    class FakeSMTP:
        def __init__(self, host, port):
            sent.append(("connect", host, port))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            sent.append(("quit",))

        def starttls(self):
            sent.append(("starttls",))

        def login(self, user, password):
            sent.append(("login", user, password))

        def send_message(self, msg):
            sent.append(("send", msg["From"], msg["To"], msg["Subject"],
                         msg.get_payload()[0].get_payload()))

    for mod in (juserops, tuserops):
        monkeypatch.setattr(mod.smtplib, "SMTP", FakeSMTP)
    juserops.send_password_email("a@x", "pw", "bob", "bob@y", "s3cret", "smtp.test", 2525)
    n = len(sent)
    tuserops.send_password_email("a@x", "pw", "bob", "bob@y", "s3cret", "smtp.test", 2525)
    assert sent[n:] == sent[:n]
    assert sent[0] == ("connect", "smtp.test", 2525) and "password: s3cret" in sent[3][4]


def test_new_user_set_files_equal_jax(tmp_path):
    src = tmp_path / "base"
    (src / "coll").mkdir(parents=True)
    (src / "coll" / "points.json").write_text('{"n": 3}')
    tar = tmp_path / "base.tar.gz"
    with tarfile.open(tar, "w:gz") as t:
        t.add(src, arcname=".")
    dirs = [mod.new_user_set_files("ann", str(tar), str(tmp_path / name))
            for name, mod in (("jax", juserops), ("port", tuserops))]
    assert dirs == [str(tmp_path / "jax" / "ann"), str(tmp_path / "port" / "ann")]
    files = [sorted(str(p.relative_to(d)) for p in Path(d).rglob("*")) for d in dirs]
    assert files[0] == files[1] and "coll/points.json" in files[0]


# -- the four client functions of api ---------------------------------------------------------


def _docs(cls, tmp_path):
    imgs = []
    for i in range(2):
        p = tmp_path / f"fig{i}.png"
        p.write_bytes(bytes([i]) * (40 + i))
        imgs.append(str(p))
    return [cls(page_content="fig one", metadata={"type": "image", "img_link": imgs[0],
                                                   "document_name": "a.pdf", "page_no": 1}),
            cls(page_content="plain text chunk", metadata={"type": "text", "page_no": 2}),
            cls(page_content="fig two", metadata={"type": "image", "img_link": imgs[1],
                                                   "document_name": "b.pdf", "page_no": 3}),
            cls(page_content="| a | b |", metadata={"type": "table", "page_no": 4})]


def _answer(req):
    return f"{req['model']}: summary of {len(json.dumps(req['messages']))} chars"


def _plain(docs):
    if isinstance(docs, dict):
        return {k: _plain(v) for k, v in docs.items()}
    return [(d.page_content, d.metadata) for d in docs]


def test_get_img_summary_and_process_models_equal_jax(tmp_path):
    prompts = {"img_summary": "Describe the figure.", "text_summary": "Summarize: "}
    models = [{"model_name": "google/gemma-3-27b-it", "model_short": "gemma3", "port": 8006},
              {"model_name": "gpt-5-nano", "model_short": "nano", "port": 0}]
    got = {}
    for name, api, cls in (("jax", japi, JDocument), ("port", tapi, TDocument)):
        docs = _docs(cls, tmp_path)
        save = tmp_path / f"{name}.pkl"
        with FakeOpenAIServer(_answer) as fake:
            one = asyncio.run(api.get_img_summary(docs, prompts, "m", 0, str(save),
                                                  base_url=fake.base_url))
            per_model = asyncio.run(api.process_models(docs, prompts, models,
                                                       base_url=fake.base_url))
            none = asyncio.run(api.get_img_summary(docs[1:2], prompts, "m", 0, "",
                                                   base_url=fake.base_url))
            reqs = sorted(json.dumps(r, sort_keys=True) for r in fake.requests)
        got[name] = (_plain(one), _plain(per_model), _plain(none), reqs,
                     _plain(pickle.loads(save.read_bytes())), _plain(docs))
    assert got["port"] == got["jax"]
    one, per_model, none, reqs, saved, docs = got["port"]
    assert saved == one and docs == _plain(_docs(TDocument, tmp_path))   # inputs untouched
    assert [c for c, _ in one] == [
        _answer({"model": "m", "messages": tapi.prompt_prep(
            [_docs(TDocument, tmp_path)[0]], prompts["img_summary"], "")[0]}),
        "plain text chunk", one[2][0], "| a | b |"]
    assert set(per_model) == {"orig_model", "gemma3", "nano"}
    assert len(reqs) == 2 + 2 * 2


def _models_reply(n, method, path, body):
    if path != "/v1/models":
        return 404, b"{}"
    return 200, json.dumps({"object": "list", "data": [{"id": "served-model"}]}).encode()


@pytest.mark.parametrize("env", [None, DOWN + "/v1"])
def test_models_local_and_models_used_equal_jax(monkeypatch, capsys, env):
    if env:
        monkeypatch.setenv("API_URL", env)
    else:
        monkeypatch.delenv("API_URL", raising=False)
    monkeypatch.setenv("OPENAI_API_KEY", "sk-o")
    with Endpoint(_models_reply) as good, \
            Endpoint(lambda n, m, p, b: (503, b"{}")) as bad, \
            Endpoint(lambda n, m, p, b: (200, b'{"data": []}')) as empty:
        ports = [int(e.root.rsplit(":", 1)[1]) for e in (good, bad, empty)] + [9]
        local = [api.models_local(ports, api_key="key") for api in (japi, tapi)]
        used = [api.models_used(ports, ["gpt-5", "gpt-5-mini"], "RAG_TEXT", vd)
                for api in (japi, tapi) for vd in (["mm1", "mm2", "mm3", "mm4", "mm5", "mm6"],
                                                   ["only-one"])]
    assert local[1] == local[0]
    assert used[2:] == used[:2]
    out = capsys.readouterr().out
    # 3 calls of models_local a package; 3 ports fail, or all 4 under API_URL
    assert out.count("api connection error:") == 2 * 3 * (4 if env else 3)
    if env:
        assert all(m["model_id"] == "Not_working" and m["api_url"] == env and
                   m["api_key"] == env for m in local[1])
        assert [m["model_id"] for m in used[2]] == ["gpt-5", "gpt-5-mini"]
    else:
        assert [m["model_id"] for m in local[1]] == ["served-model"] + ["Not_working"] * 3
        assert local[1][0] == {"model_id": "served-model",
                               "api_url": f"http://localhost:{ports[0]}/v1", "api_key": "key"}
        assert [m["model_id"] for m in used[2]] == ["served-model", "gpt-5", "gpt-5-mini"]
        assert [m["vd_MM"] for m in used[2]] == ["mm1", "mm5", "mm6"]
        assert "vd_MM" not in used[3][0] and used[3][0]["vd_text"] == "RAG_TEXT"
    assert "Length of multimodal vectoDB 1 not equals to models  6." in out


def test_only_create_document_embeddings_still_raises():
    """It was the last api function that raised ``NotImplementedError``
    (ROADMAP queue 1 item 4, ingest); now none does, and it embeds a
    directory of PDFs: on an empty one, none."""
    import inspect
    import types

    src = inspect.getsource(tapi)
    assert "NotImplementedError" not in src and "_not_ported" not in src
    with tempfile.TemporaryDirectory() as d:
        assert tapi.create_document_embeddings(
            d, model=types.SimpleNamespace(device=torch.device("cpu"))) == []
