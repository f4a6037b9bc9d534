"""The port's Llama-3.2-Vision engine served: per-slot cross-KV pools in the
dense and paged batchers, the cross hooks in both speculative tiers, and the
HTTP server, against the JAX package's engines on the CPU (float32).

Image requests beside text requests stream token for token what JAX's
``MllamaMMEngine.generate`` and ``LlamaDecodeEngine.generate`` give, in the
dense and the paged batcher (native and int8 KV pools against JAX's paged
batcher; int8 and int4 weights in tests/test_torch_mllama.py), after slot
reuse, and for a preempted image request; both speculative batchers equal greedy decode. A
request past ``cross_max_images`` fails with JAX's message, prefix caching
never shares an image prompt's pages, and ``serve --model tiny-mllama
--paged`` answers a text and a PNG image request over HTTP with jax and PIL
refused.
"""

import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation.engine import LlamaDecodeEngine as JText
from multimodal_colpali_tpu.generation.mllama_mm import MllamaMMEngine as JMM
from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.generation.speculative import (
    SpeculativeContinuousBatcher, SpeculativePagedContinuousBatcher)
from tests.test_torch_mllama import build, images, jax_params

torch.set_num_threads(1)

TEXT = [40, 2, 7]


@pytest.fixture(scope="module")
def served():
    """(cfg, JAX params, JAX text engine, JAX image engine, port text, port
    image, the JAX streams every batcher is held to)."""
    cfg, params = jax_params()
    jp = jax.tree.map(jnp.asarray, params)
    jeng, jmm = JText(cfg.text, jp, dtype=jnp.float32), JMM(cfg, jp, dtype=jnp.float32)
    lm, mm = build(params)
    reqs = requests(cfg, mm)
    want = [jmm.generate([p], pix[None], max_new_tokens=n, bucket=16)[0] if pix is not None
            else jeng.generate([p], max_new_tokens=n)[0] for p, pix, n in reqs]
    return cfg, params, jeng, jmm, lm, mm, reqs, want


def requests(cfg, mm):
    """(prompt, pixels or None, max_new_tokens): text, 1 and 2 images."""
    return [(TEXT, None, 8),
            (mm.build_mm_prompt([5, 9, 11], bos_id=1), images(cfg, 5, 1), 6),
            (mm.build_mm_prompt([7, 3], bos_id=1, n_images=2), images(cfg, 6, 2), 5)]


def run(bat, reqs):
    futs = [bat.submit(p, max_new_tokens=n, pixel_values=None if pix is None
                       else (pix[0] if len(pix) == 1 else pix)) for p, pix, n in reqs]
    bat.drain()
    return [f.result(60) for f in futs]


KINDS = {
    "dense": (ContinuousBatcher, {}),
    "paged": (PagedContinuousBatcher, {"page_size": 8}),
    "speculative-dense": (SpeculativeContinuousBatcher, {"spec_k": 3}),
    "speculative-paged": (SpeculativePagedContinuousBatcher, {"spec_k": 3, "page_size": 8}),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_image_and_text_requests_stream_as_the_engines(served, kind):
    """Every tier: the 1- and 2-image requests equal JAX's ``generate`` (the
    speculative tiers: greedy decode), the text request the text engine's;
    then a text request in a slot an image request held ignores its stale
    pool, and a request past the pool fails with JAX's message."""
    cfg, _, jeng, _, lm, mm, reqs, want = served
    cls, kw = KINDS[kind]
    bat = cls(lm, batch_slots=2, max_seq_len=64, chunk=3, mm_engine=mm, cross_max_images=2,
              **kw)
    assert bat._cross_skv == 2 * mm.packed_cross_tokens_per_image
    assert run(bat, reqs) == want
    assert bat._cross_len == [0, 0]
    assert run(bat, [([12, 44], None, 6)]) == jeng.generate([[12, 44]], max_new_tokens=6)
    fut = bat.submit(mm.build_mm_prompt([5], bos_id=1, n_images=3), max_new_tokens=4,
                     pixel_values=images(cfg, 7, 3))
    with pytest.raises(ValueError, match=r"3 images need 15 cross-KV rows > pool 10; "
                                         r"raise cross_max_images"):
        fut.result(1)


def test_int8_kv_pools_stream_as_jax_s_paged_batcher(served):
    """int8 self-attention pools (the cross pools stay in the model dtype):
    the port's paged batcher against JAX's on the same requests."""
    cfg, params, _, _, lm, mm, reqs, _ = served
    jp = jax.tree.map(jnp.asarray, params)
    jlm, jmm = JText(cfg.text, jp, dtype=jnp.float32), JMM(cfg, jp, dtype=jnp.float32)
    kw = dict(batch_slots=2, max_seq_len=64, chunk=3, page_size=8, kv_dtype="int8",
              cross_max_images=2)
    want = run(JPaged(jlm, mm_engine=jmm, **kw), reqs)
    got = run(PagedContinuousBatcher(lm, mm_engine=mm, **kw), reqs)
    assert got == want and [len(t) for t in got] == [8, 6, 5]


@pytest.mark.parametrize("kind", ["paged", "speculative-paged"])
def test_preempted_image_request_resumes_through_the_cross_prefill(served, kind):
    """A pool too small for both requests: the younger, an image request, is
    preempted after generating, then re-prefills prompt and generated tokens
    through ``prefill_cross`` (the packed cross rows again) and its stream
    equals the uninterrupted one."""
    cfg, _, jeng, jmm, lm, mm, _, _ = served
    pix = images(cfg, 9, 1)
    prompt = mm.build_mm_prompt([5, 9, 11], bos_id=1)
    want_mm = jmm.generate([prompt], pix[None], max_new_tokens=10, bucket=16)[0]
    want_txt = jeng.generate([[40, 2, 7, 13]], max_new_tokens=10)[0]
    cls, kw = KINDS[kind]
    bat = cls(lm, batch_slots=2, max_seq_len=64, chunk=2, pool_pages=4, mm_engine=mm, **kw)
    f_txt = bat.submit([40, 2, 7, 13], max_new_tokens=10)
    f_mm = bat.submit(prompt, max_new_tokens=10, pixel_values=pix[0])
    bat.drain()
    assert f_txt.result(60) == want_txt and f_mm.result(60) == want_mm
    assert bat.preemptions >= 1


def test_prefix_caching_never_shares_an_image_prompt(served):
    """paged.py:127-138: a cross engine's image context is not in its prompt
    pages, so image prompts share none; text prompts still do. The exact-
    prompt prefill cache keeps the cross K/V beside the rows."""
    cfg, _, jeng, jmm, lm, mm, _, _ = served
    bat = PagedContinuousBatcher(lm, batch_slots=2, max_seq_len=64, chunk=3, page_size=8,
                                 mm_engine=mm, prefix_caching=True)
    assert bat.prefix_caching and not bat._mm_prefix_ok
    pix = images(cfg, 11, 1)
    long = mm.build_mm_prompt(list(range(2, 22)), bos_id=1)
    want = jmm.generate([long], pix[None], max_new_tokens=4, bucket=16)[0]
    for _ in range(2):
        assert run(bat, [(long, pix, 4)]) == [want]
    assert bat.prefix_cache_hits == 0 and bat.prefix_prefill_hits == 0
    assert bat.prefill_cache_hits == 1          # the second asked the exact-prompt cache
    text = list(range(2, 22))
    for n in (4, 5):
        assert run(bat, [(text + [n], None, 4)]) == jeng.generate([text + [n]],
                                                                  max_new_tokens=4)
    assert bat.prefix_cache_hits > 0


# -- serving -------------------------------------------------------------------------------------

def test_serve_builds_mllama_with_its_flags(monkeypatch):
    """07_serve.py:173-205, :280-292: --tiles picks the layout, --weight-dtype
    quantizes the LM and the cross layers once, the image engine decodes
    through the text engine, --cross-max-images sizes the pools."""
    from multimodal_colpali_tpu_torch import serve
    from multimodal_colpali_tpu_torch.ops.quant import is_quantized

    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    args = serve.parse_args(["--model", "tiny-mllama", "--device", "cpu", "--dtype",
                             "float32", "--weight-dtype", "int8", "--tiles", "2x1",
                             "--cross-max-images", "3", "--vision-dtype", "int8"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng, tok, mm, pre = serve.build(args)
    assert type(eng).__name__ == "LlamaDecodeEngine" and eng.weight_dtype == "int8"
    assert type(mm).__name__ == "MllamaMMEngine" and mm.lm is eng and mm.tiles == (2, 1)
    assert is_quantized(mm.cross_params["1"]["cross_attn"]["q_proj"]["kernel"])
    assert mm.vision_tower.global_0.fc1.weight.dtype == torch.int8
    pix = pre([np.full((40, 60, 3), 120, np.uint8)])
    assert pix.shape == (1, 2, 28, 28, 3)
    bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, mm_engine=mm,
                                 cross_max_images=args.cross_max_images)
    assert bat._cross_skv == 3 * 2 * 5
    prompt = mm.build_mm_prompt(tok.encode("hi"), bos_id=tok.bos_id)
    assert run(bat, [(prompt, pix, 3)]) == mm.generate([prompt], pix[None], max_new_tokens=3)


def test_server_without_a_batcher_answers_images_and_a_constrained_choice(served):
    """``--no-batcher``: the server generates from the image engine itself, and
    its constrained (enum) path scores the choices on the images' logits."""
    import base64
    import json
    import urllib.request

    from multimodal_colpali_tpu_torch.generation.engine import ModuloTokenizer
    from multimodal_colpali_tpu_torch.generation.mllama_mm import MllamaImagePreprocessor
    from multimodal_colpali_tpu_torch.generation.server import (
        GenerationServer, render_chat_prompt)
    from multimodal_colpali_tpu_torch.ingest.imageops import encode_png

    cfg, _, _, _, lm, mm, _, _ = served
    tok = ModuloTokenizer(cfg.text.vocab_size)
    srv = GenerationServer(lm, tok, model_name="tiny-mllama", port=0, max_new_tokens=8,
                           mm_engine=mm, image_preprocessor=MllamaImagePreprocessor(cfg)).start()
    try:
        png = encode_png(np.full((30, 40, 3), (200, 20, 90), np.uint8))
        url = "data:image/png;base64," + base64.b64encode(png).decode()
        content = [{"type": "image_url", "image_url": {"url": url}},
                   {"type": "text", "text": "what is it"}]

        def ask(body):
            req = urllib.request.Request(srv.base_url + "/chat/completions",
                                         json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.load(r)["choices"][0]["message"]["content"]

        reply = ask({"model": "m", "max_tokens": 5,
                     "messages": [{"role": "user", "content": content}]})
        prompt = render_chat_prompt([{"role": "user", "content": content}])
        ids, pix = srv._prepare_ids(prompt, [np.full((30, 40, 3), (200, 20, 90), np.uint8)])
        assert ids[:2] == [tok.bos_id, cfg.image_token_id] and pix.shape == (1, 2, 28, 28, 3)
        assert reply == tok.decode(mm.generate([ids], pix[None], max_new_tokens=5)[0])
        schema = {"type": "object", "properties": {"answer": {"enum": ["A", "B", "C"]}}}
        choice = ask({"model": "m", "max_tokens": 5, "messages": [
            {"role": "user", "content": content}],
            "response_format": {"type": "json_schema", "json_schema": {"schema": schema}}})
        assert json.loads(choice)["answer"] in ("A", "B", "C")
    finally:
        srv.stop()


SERVE_GUARD = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "PIL", "pandas", "aiohttp", "transformers"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from multimodal_colpali_tpu_torch import serve
serve.main(sys.argv[1:])
"""


def test_serve_cli_mllama_answers_text_and_an_image_without_jax_or_pillow():
    """``serve --model tiny-mllama --paged`` as a subprocess (the counterpart
    of tests/test_drivers_e2e.py::test_serve_cli_mllama): a text request twice
    (one greedy reply) and a PNG image request, with jax and PIL refused."""
    import base64
    import json
    import os
    import subprocess
    import urllib.request
    from pathlib import Path

    from multimodal_colpali_tpu_torch.ingest.imageops import encode_png

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    env.pop("COLPALI_TPU_CKPT_DIR", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_GUARD, "--model", "tiny-mllama", "--port", "0", "--paged",
         "--max-seq-len", "128", "--dtype", "float32", "--device", "cpu", "--cross-max-images",
         "2"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        base = None
        for line in proc.stdout:
            if line.startswith("[serve]"):
                base = line.split(" on ")[1].split()[0]
                break
        assert base, "serve did not start"

        def ask(content, n):
            body = {"model": "mllama", "max_tokens": n,
                    "messages": [{"role": "user", "content": content}]}
            req = urllib.request.Request(base + "/chat/completions", json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.load(r)["choices"][0]["message"]["content"]

        text = ask("hello world", 8)
        assert text and ask("hello world", 8) == text
        png = encode_png(np.full((56, 40, 3), (30, 200, 90), np.uint8))
        url = "data:image/png;base64," + base64.b64encode(png).decode()
        assert len(ask([{"type": "image_url", "image_url": {"url": url}},
                        {"type": "text", "text": "describe"}], 6).split()) == 6
        with urllib.request.urlopen(base.rsplit("/v1", 1)[0] + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert (stats["images_decoded"], stats["images_skipped"]) == (1, 0), stats
    finally:
        proc.terminate()
        proc.wait(timeout=30)
