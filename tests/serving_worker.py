"""One rank of a gloo world for ``tests/test_torch_tp_serving.py``.

Run as ``python tests/serving_worker.py WORLD RANK RENDEZVOUS_FILE OUT_DIR``:
the rank joins the group through ``initialize_distributed(file://...)`` and
serves over every mesh of its world: the mesh's first rank (the leader)
submits, drains or serves HTTP, the others follow its admission records. It
writes what it got to ``OUT_DIR/rank<RANK>.npz``: the leader's streams and
replies, and every rank's counters and cache shapes. The image models'
parameters are numpy trees the test wrote to ``OUT_DIR/../params`` before it
started the world (the JAX package's random initializers, which this process
cannot import); the inputs are made here from numpy seeds, and the test
imports the same functions. This module imports torch and the port only.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np

import parallel_worker as PW

REPO = PW.REPO
NEW_TOKENS = PW.NEW_TOKENS

# (a): the dense caches over data
DENSE_MODELS = ("gemma1", "gemma3kv2")
DENSE_BATCHERS = ("ContinuousBatcher", "SpeculativeContinuousBatcher")
DENSE_SLOTS = (4, 3)            # 3 slots do not split over data = 2: every rank keeps them

# (b): the front end. The requests' order is their submit order.
FRONT = dict(slots=6, timeout=1.5, max_queue=6)
MCQ_CHOICES = ["A", "B", "C", "D"]


def _chat(content, **kw):
    return dict({"messages": [{"role": "user", "content": content}]}, **kw)


def front_requests():
    """name -> chat body: six completions (greedy at three lengths, one
    streaming, one sampled with a seed, one structured MCQ), sent at once."""
    schema = {"type": "json_schema", "json_schema": {"name": "mcq", "schema": {
        "type": "object", "properties": {"answer": {"type": "string", "enum": MCQ_CHOICES}},
        "required": ["answer"]}}}
    return {"greedy3": _chat("alpha beta", max_tokens=3),
            "greedy6": _chat("the third question about glycans", max_tokens=6),
            "greedy9": _chat("gamma", max_tokens=9),
            "stream": _chat("a streamed answer", max_tokens=5, stream=True),
            "sampled": _chat("sampled", max_tokens=6, temperature=0.9, seed=5),
            "mcq": _chat("Which one? A) x B) y C) z D) w", response_format=schema)}


EXPIRING = _chat("this one waits past the deadline", max_tokens=4)
REJECTED = _chat("one past the queue bound", max_tokens=4)

# (c): the image engines
IMAGE_MODELS = ("pali", "gemma3", "qwen2vl", "llava", "mllama")
IMAGE_TEXT = [40, 2, 7]


def post(base_url, body, timeout=120.0):
    """(status, content, finish_reason) of a chat completion; a streaming
    one's content is its chunks joined; an error's content is its type."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base_url + "/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]["type"], None
    if not body.get("stream"):
        choice = json.loads(raw)["choices"][0]
        return status, choice["message"]["content"], choice["finish_reason"]
    text, finish = "", None
    for line in raw.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        ev = json.loads(line[6:])
        choice = ev["choices"][0]
        text += choice["delta"].get("content", "")
        finish = choice["finish_reason"] or finish
    return status, text, finish


# -- models -------------------------------------------------------------------------------

def unflatten(flat):
    tree: dict = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def load_params(params_dir, name):
    with np.load(Path(params_dir) / f"{name}.npz") as z:
        return unflatten({k: z[k] for k in z.files})


def gemma3_mm_config():
    """Gemma-3 with images over 4 query heads and 2 KV heads (the KV heads
    split over model = 2), 4 soft tokens an image."""
    from multimodal_colpali_tpu_torch.models.configs import (
        Gemma3MMConfig, Gemma3TextConfig, SiglipVisionConfig)

    text = Gemma3TextConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                            head_dim=8, sliding_window=8, sliding_window_pattern=2,
                            query_pre_attn_scalar=8.0)
    vision = SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14)
    return Gemma3MMConfig(vision=vision, text=text, image_token_id=63, mm_tokens_per_image=4)


def image_engine(name, params_dir, mesh=None):
    """(image engine, its preprocessor) of a tiny image model, float32 on the
    CPU, its LM over ``mesh``."""
    import torch

    from multimodal_colpali_tpu_torch.generation import engine as E
    from multimodal_colpali_tpu_torch.models import convert as C, registry as TR

    f32 = dict(dtype=torch.float32, device="cpu")
    if name == "pali":       # the ColPali golden: Gemma-2B's shape, 2 query heads over 1 KV head
        from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
        from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
        from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor

        cfg = ColPaliModelConfig.tiny()
        model = ColPaliModel(cfg, **f32).eval()
        model.load_state_dict(C.params_from_flax(PW.goldens_params("tiny-colpali"), cfg))
        lm = E.GemmaDecodeEngine(cfg.text, C.engine_params_from_state_dict(model.state_dict()),
                                 device="cpu", mesh=mesh)
        return E.PaliGemmaEngine(model, lm=lm), ImagePreprocessor(cfg.vision.image_size)
    params = load_params(params_dir, name)
    if name == "gemma3":
        from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine
        from multimodal_colpali_tpu_torch.models.processing import ImagePreprocessor
        from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower

        cfg = gemma3_mm_config()
        lm_tree, tower_sd, projector = C.gemma3_mm_params_from_jax(params, cfg, device="cpu")
        tower = SiglipVisionTower(cfg.vision, **f32).eval()
        tower.load_state_dict(tower_sd)
        lm = E.GemmaDecodeEngine(cfg.text, lm_tree, device="cpu", mesh=mesh)
        return (Gemma3MMEngine(cfg, tower, projector, lm=lm),
                ImagePreprocessor(cfg.vision.image_size))
    if name == "qwen2vl":
        from multimodal_colpali_tpu_torch.generation.qwen2vl_mm import (
            Qwen2VLImagePreprocessor, Qwen2VLMMEngine)
        from multimodal_colpali_tpu_torch.models.qwen2vl import Qwen2VisionTower

        cfg = TR._QWEN2VL_FULL["tiny-qwen2vl"]()
        lm_tree, tower_sd = C.qwen2vl_mm_params_from_jax(params, cfg, device="cpu")
        tower = Qwen2VisionTower(cfg.vision, **f32).eval()
        tower.load_state_dict(tower_sd)
        lm = E.Qwen2DecodeEngine(cfg.text, lm_tree, device="cpu", mesh=mesh)
        return Qwen2VLMMEngine(cfg, tower, lm), Qwen2VLImagePreprocessor(cfg)
    if name == "llava":
        from multimodal_colpali_tpu_torch.generation.llava_next_mm import (
            LlavaNextImagePreprocessor, LlavaNextMMEngine)
        from multimodal_colpali_tpu_torch.models.clip import ClipFeatureTower

        cfg = TR.LLAVA_NEXT_CONFIGS["tiny-llava-next"]()
        lm_tree, tower_sd, projector = C.llava_next_params_from_jax(params, cfg, device="cpu")
        tower = ClipFeatureTower(cfg.vision, cfg.vision_feature_layer, **f32).eval()
        tower.load_state_dict(tower_sd)
        lm = E.LlamaDecodeEngine(cfg.text, lm_tree, device="cpu", mesh=mesh)
        return LlavaNextMMEngine(cfg, tower, projector, lm), LlavaNextImagePreprocessor(cfg)
    from multimodal_colpali_tpu_torch.generation.mllama_mm import (
        MllamaImagePreprocessor, MllamaMMEngine)
    from multimodal_colpali_tpu_torch.models.mllama import MllamaVisionTower

    cfg = TR.MLLAMA_CONFIGS["tiny-mllama"]()
    lm_tree, tower_sd, projector, cross = C.mllama_params_from_jax(params, cfg, device="cpu")
    tower = MllamaVisionTower(cfg.vision, **f32).eval()
    tower.load_state_dict(tower_sd)
    lm = E.LlamaDecodeEngine(cfg.text, lm_tree, device="cpu", mesh=mesh)
    return MllamaMMEngine(cfg, tower, projector, cross, lm), MllamaImagePreprocessor(cfg)


def image_inputs(name, mm):
    """(prompt, uint8 images or None, max_new_tokens): a text request, a
    1-image and a 2-image one."""
    rng = np.random.default_rng(40 + IMAGE_MODELS.index(name))
    imgs = [rng.integers(0, 256, (30 + 3 * i, 26 + 2 * i, 3), dtype=np.uint8) for i in range(3)]
    return [(IMAGE_TEXT, None, NEW_TOKENS),
            (mm.build_mm_prompt([5, 9, 11], bos_id=1), imgs[:1], 6),
            (mm.build_mm_prompt([7, 3], bos_id=1, n_images=2), imgs[1:], 5)]


def image_batchers(name):
    """(batcher class name, kwargs) an image model serves through."""
    paged = ("PagedContinuousBatcher", dict(page_size=8))
    if name == "mllama":
        return [paged, ("ContinuousBatcher", {})]
    return [paged]


def batcher_class(name):
    from multimodal_colpali_tpu_torch.generation import paged as PG
    from multimodal_colpali_tpu_torch.generation import scheduler as SC, speculative as SP

    return {m: getattr(mod, m) for mod in (SC, PG, SP) for m in dir(mod)}[name]


def counters(bat):
    """What every rank must count alike."""
    return np.array([bat.admissions, bat.decode_steps, bat.decode_tokens, bat.expired,
                     bat.constrained_forwards, bat.records], np.int64)


# -- the rank's work -----------------------------------------------------------------------

def lead(bat, requests, pre=None):
    """The leader: preprocess, submit, drain, stop the followers -> the
    streams."""
    futs = [bat.submit(p, max_new_tokens=n, pixel_values=None if imgs is None else pre(imgs))
            for p, imgs, n in requests]
    bat.drain()
    bat.shutdown()
    return [f.result(60) for f in futs]


def dense_caches(res, tag, mesh):
    from multimodal_colpali_tpu_torch.generation import engine as E

    for model in DENSE_MODELS:
        cfg, params = PW.decode_model(model)
        eng = E.GemmaDecodeEngine(cfg, params, device="cpu", mesh=mesh)
        for cls in DENSE_BATCHERS:
            for slots in DENSE_SLOTS:
                key = f"dense/{tag}/{model}/{cls}/{slots}"
                bat = batcher_class(cls)(eng, batch_slots=slots, max_seq_len=64, chunk=3)
                if mesh.is_leader:
                    streams = lead(bat, [(p, None, NEW_TOKENS) for p in PW.PROMPTS])
                    res[key] = PW.streams_array(streams)
                else:
                    bat.follow()
                res[key + "/slots"] = np.array(bat._kc[0].shape[0])
                res[key + "/counters"] = counters(bat)


def front_batcher(engine):
    from multimodal_colpali_tpu_torch.generation import PagedContinuousBatcher

    return PagedContinuousBatcher(engine, batch_slots=FRONT["slots"], max_seq_len=96, chunk=3,
                                  page_size=8, max_queue=FRONT["max_queue"],
                                  admission_timeout=FRONT["timeout"]).serve()


def front_replies(engine, tok):
    """The leader's side of (b): a paged batcher behind GenerationServer;
    the client sends the requests at once while the loop waits on the
    batcher's lock, the expiring one first -> (name -> reply, batcher)."""
    from multimodal_colpali_tpu_torch.generation import GenerationServer

    bat = front_batcher(engine)
    srv = GenerationServer(bat, tok).start()
    replies, threads = {}, []

    def fire(name, body):
        t = threading.Thread(target=lambda: replies.__setitem__(name, post(srv.base_url, body)))
        t.start()
        threads.append(t)

    def wait_for(cond, what):
        deadline = time.monotonic() + 60
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"front end: {what} never arrived")
            time.sleep(0.01)

    try:
        with bat._lock:          # the loop waits: the submits gather for one record
            fire("expired", EXPIRING)
            wait_for(lambda: bat._queue.qsize() == 1, "the expiring request")
            time.sleep(FRONT["timeout"] + 0.3)
            for name, body in front_requests().items():
                fire(name, body)
            wait_for(lambda: bat._queue.qsize() == FRONT["max_queue"]
                     and bat._forwards.qsize() == 1, "the six requests")
            replies["rejected"] = post(srv.base_url, REJECTED)
        for t in threads:
            t.join(120)
    finally:
        srv.stop()
        bat.shutdown()
    return replies, bat


def front_end(res, tag, mesh):
    """(b) on one rank: the leader's replies, or a follower's server, which
    binds nothing and follows until the leader's batcher shuts down."""
    from multimodal_colpali_tpu_torch.generation import (
        GemmaDecodeEngine, GenerationServer, ModuloTokenizer)

    cfg, params = PW.decode_model("gemma1")
    eng = GemmaDecodeEngine(cfg, params, device="cpu", mesh=mesh)
    tok = ModuloTokenizer(cfg.vocab_size)
    key = f"front/{tag}"
    if mesh.is_leader:
        replies, bat = front_replies(eng, tok)
        res[key + "/replies"] = np.array(json.dumps(replies))
        res[key + "/rejected"] = np.array(bat.rejected)
    else:
        made, plain = [], socket.socket

        class Counting(plain):   # the sockets this rank opens from here on
            def __init__(self, *a, **kw):
                made.append(a)
                super().__init__(*a, **kw)

        socket.socket = Counting
        try:
            bat = front_batcher(eng)
            srv = GenerationServer(bat, tok)
            srv.start()          # follows until the leader's batcher shuts down
        finally:
            socket.socket = plain
        res[key + "/sockets"] = np.array(len(made))
        res[key + "/bound"] = np.array(srv.base_url is not None)
    res[key + "/counters"] = counters(bat)


def images(res, tag, mesh, params_dir):
    for name in IMAGE_MODELS:
        mm, pre = image_engine(name, params_dir, mesh)
        for cls, kw in image_batchers(name):
            key = f"img/{tag}/{name}/{cls}"
            extra = dict(cross_max_images=2) if name == "mllama" else {}
            bat = batcher_class(cls)(mm.lm, batch_slots=4, max_seq_len=96, chunk=3,
                                     mm_engine=mm, **kw, **extra)
            if mesh.is_leader:
                res[key] = PW.streams_array(lead(bat, image_inputs(name, mm), pre))
            else:
                bat.follow()
            res[key + "/counters"] = counters(bat)
            if name == "mllama":
                res[key + "/cross_slots"] = np.array(bat._cross_k.shape[1])


def main(world: int, rank: int, rendezvous: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from multimodal_colpali_tpu_torch.parallel import get_mesh, initialize_distributed

    initialize_distributed(f"file://{rendezvous}", world, rank, device="cpu")
    params_dir = Path(out_dir).parent / "params"
    res = {}
    meshes = ({"dp2tp2": (2, 2)} if world == 4 else {"tp2": (1, 2), "dp2": (2, 1)})
    for tag, shape in meshes.items():
        mesh = get_mesh(("data", "model"), shape)
        with torch.inference_mode():
            dense_caches(res, tag, mesh)
        front_end(res, tag, mesh)
        if shape != (2, 1):
            with torch.inference_mode():
                images(res, tag, mesh, params_dir)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
