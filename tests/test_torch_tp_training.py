"""The port's DP x TP training against the single-device port and JAX's
trainer on a mesh, on the CPU.

A gloo world of 2 and one of 4 ranks are started once for the module, each
rank running ``tests/tp_training_worker.py`` (a ``file://`` rendezvous under
the test's temporary directory; a world past ``WORLD_TIMEOUT`` seconds is
killed and its tests fail). Every rank trains the worker's tiny ColPali (4
SigLIP heads, 4 Gemma query heads over 1 KV head) for 3 AdamW steps on one
global batch of 4 on the meshes (data, model) = (2, 1), (1, 2), (2, 2),
(4, 1), (1, 4) and (2, 2) with ``remat``. Each case is held against

- (a) the single-device port on the global batch, and
- (b) JAX's ``make_training_setup`` / ``make_train_step`` on a mesh of the
  same shape over conftest's 8 virtual devices (its gradients by
  ``jax.value_and_grad`` of the same loss on that mesh),

at the tolerances of ``tests/test_torch_training.py``: loss rel 1e-5, each
gradient within 1e-5 of its leaf's largest element plus 1e-7, parameters
within 1e-5, the k-projection biases (true gradient 0: both packages step
them by rounding noise) within 2 lr a step. The starting parameters are
``fast_random_params`` with every bias and norm weight moved off its
initial constant, so a wrong slice of a bias shows at step 1.
"""

import dataclasses
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import parallel_worker
import tp_training_worker as W
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JCfg
from multimodal_colpali_tpu.models.registry import fast_random_params
from multimodal_colpali_tpu.parallel import mesh as JM
from multimodal_colpali_tpu.training import trainer as JT
from multimodal_colpali_tpu_torch import parallel as TP
from multimodal_colpali_tpu_torch.generation import engine as TE
from multimodal_colpali_tpu_torch.models import convert
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.colpali import shard_model_for_tp
from multimodal_colpali_tpu_torch.ops import fused_layer as FL
from multimodal_colpali_tpu_torch.training import make_train_step, make_training_setup
from multimodal_colpali_tpu_torch.training.checkpoint import (
    make_checkpoint_manager, restore_train_state, save_train_state)

torch.set_num_threads(1)

WORLD_TIMEOUT = 120.0
LR, STEPS = W.LR, W.STEPS
TCFG = W.tp_cfg()
JCFG = dataclasses.replace(
    JCfg.tiny(), vision=dataclasses.replace(JCfg.tiny().vision, num_attention_heads=4,
                                            image_size=56),
    text=dataclasses.replace(JCfg.tiny().text, num_attention_heads=4))
CASES = {name: (shape, remat, world) for world, cases in W.CASES.items()
         for name, (shape, remat) in cases.items()}
NOISE_LEAVES = {f"vision_tower.layers.{i}.self_attn.k_proj.bias" for i in range(2)}


def _param_tolerance(steps: int) -> float:
    """The bound of an element whose gradient is rounding noise in both
    packages: Adam turns its sign into about +-lr a step."""
    return 2 * LR * steps


# -- inputs and references ----------------------------------------------------------------

def _init_flat():
    """``fast_random_params`` of the JAX model (flat flax keys), every bias
    and LayerNorm / RMSNorm weight moved by a seeded N(0, 0.1)."""
    flat = convert.flatten_flax(jax.tree.map(np.asarray,
                                             fast_random_params(JColPali(JCFG), JCFG, 0)))
    rng = np.random.default_rng(5)
    for k, v in flat.items():
        if k.endswith(("/bias", "/scale")):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return flat


def _nest(flat):
    tree = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


def _in_port_layout(jtree):
    return {k: v.numpy() for k, v in convert.params_from_flax(
        convert.flatten_flax(jax.tree.map(np.asarray, jtree)), TCFG).items()}


def _jmesh(shape):
    return JMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape),
                 ("data", "model"))


def _jax_loss_fn(model, batch):
    def loss_fn(params):
        q = model.apply({"params": params}, batch["query_ids"], batch["query_mask"], None)
        d = model.apply({"params": params}, batch["doc_ids"], batch["doc_mask"],
                        batch["doc_pixels"])
        return JT.colbert_loss(q, d, batch["query_mask"], batch["doc_mask"])

    return loss_fn


def _jax_run(flat, shape, steps=STEPS):
    """JAX's trainer on a ``shape`` mesh: the gradient at the start (port
    layout), each step's loss and parameters (port layout), and the optax
    state after step 1."""
    model, mesh = JColPali(JCFG), _jmesh(shape)
    params, opt_state, optimizer = JT.make_training_setup(model, _nest(flat), mesh=mesh,
                                                          learning_rate=LR)
    sharding = NamedSharding(mesh, P("data"))
    batch = {k: jax.device_put(jnp.asarray(v), sharding) for k, v in W.tp_batch().items()}
    grads = jax.jit(jax.grad(_jax_loss_fn(model, batch)))(params)
    step = JT.make_train_step(model, optimizer, mesh=mesh)
    out = {"grad": _in_port_layout(grads), "loss": [], "params": []}
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, batch)
        out["loss"].append(float(loss))
        out["params"].append(_in_port_layout(params))
        if i == 0:
            out["opt_state1"] = jax.tree.map(np.asarray, opt_state)
            out["params1"] = convert.flatten_flax(jax.tree.map(np.asarray, params))
    return out


def _single_run(flat, ckpt_dir=None):
    """The single-device port on the global batch: losses, the gradient
    after step 1 and the parameters after each step (numpy, by name);
    ``ckpt_dir`` gets its step-2 checkpoint."""
    model = W.new_model(flat)
    opt = make_training_setup(model, LR)
    step = make_train_step(model, opt)
    batch = W.torch_batch(W.tp_batch())
    out = {"loss": [], "params": []}
    for i in range(1, STEPS + 1):
        out["loss"].append(float(step(batch)))
        if i == 1:
            out["grad"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        out["params"].append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
        if ckpt_dir is not None and i == W.SAVE_STEP:
            save_train_state(make_checkpoint_manager(ckpt_dir), i, model, opt)
    return out


# -- the worlds ---------------------------------------------------------------------------

def _start(world: int, root: Path):
    out = root / f"w{world}"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(W.REPO))
    procs = [subprocess.Popen([sys.executable, W.__file__, str(world), str(r),
                               str(out / "rendezvous"), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, time.monotonic(), out


def _finish(started):
    """Every rank's results, or a failure: a rank that failed, or a world
    still running after WORLD_TIMEOUT (its ranks killed)."""
    procs, t0, out = started
    logs = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(WORLD_TIMEOUT - (time.monotonic() - t0), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail(f"a world of {len(procs)} ranks hung past {WORLD_TIMEOUT} s")
        logs.append((p.returncode, text))
    for r, (rc, text) in enumerate(logs):
        assert rc == 0, f"rank {r} of {len(procs)} failed:\n{text[-4000:]}"
    return [W.load_flat(out / f"rank{r}.npz") for r in range(len(procs))]


class _Run:
    """The references and both worlds: world 4 starts once the single-device
    checkpoint it resumes exists, world 2 once JAX's (1, 2) optax state
    does; the JAX meshes run while the ranks do."""

    def __init__(self, root: Path):
        self.root = root
        self.flat = _init_flat()
        np.savez(root / "init.npz", **self.flat)
        self.single = _single_run(self.flat, root / "ckpt_single")
        self._started = {4: _start(4, root)}
        self._done = {}
        try:
            self._jax = {(1, 2): _jax_run(self.flat, (1, 2))}
            j = self._jax[(1, 2)]
            adam = j["opt_state1"][0]     # optax.adamw: (ScaleByAdamState, ...)
            optax_flat = {f"params/{k}": v for k, v in j["params1"].items()}
            for part in ("mu", "nu"):
                optax_flat.update({f"{part}/{k}": v for k, v in
                                   convert.flatten_flax(getattr(adam, part)).items()})
            np.savez(root / "optax.npz", count=np.asarray(adam.count), **optax_flat)
            self._started[2] = _start(2, root)
        except BaseException:
            self.close()
            raise

    def jax(self, shape):
        if shape not in self._jax:
            self._jax[shape] = _jax_run(self.flat, shape)
        return self._jax[shape]

    def world(self, n: int):
        if n not in self._done:
            self._done[n] = _finish(self._started.pop(n))
        return self._done[n]

    def close(self) -> None:
        for procs, _, _ in self._started.values():
            for p in procs:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    r = _Run(tmp_path_factory.mktemp("tp_training"))
    yield r
    r.close()


def _coords(rank: int, shape):
    return rank // shape[1], rank % shape[1]


def _cut(full: np.ndarray, dim: int, tp: int, m: int) -> np.ndarray:
    return full if dim < 0 else np.split(full, tp, axis=dim)[m]


def _rank_views(run, name):
    """(rank, model coordinate, its results) of a case's ranks, and the
    split dims."""
    shape, _, world = CASES[name]
    ranks = run.world(world)
    dims = {k.split("/dim/", 1)[1]: int(v) for k, v in ranks[0].items()
            if k.startswith(f"{name}/dim/")}
    return [(r, _coords(r, shape)[1], res) for r, res in enumerate(ranks)], dims, shape


def _close_grads(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-7,
                               err_msg=msg)


def _close_params(got, want, name, steps, msg):
    bound = _param_tolerance(steps) if name in NOISE_LEAVES else 1e-5
    diff = float(np.abs(got - want).max())
    assert diff <= bound, (msg, name, steps, diff)


# -- the mesh cases -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_mesh_losses_match_one_device_and_jax(run, name):
    """Every step's loss, equal on every rank, within rel 1e-5 of the
    single-device port's and of JAX's on the same mesh shape."""
    views, _, shape = _rank_views(run, name)
    j = run.jax(shape)
    for r, _, res in views:
        got = res[f"{name}/loss"]
        np.testing.assert_array_equal(got, views[0][2][f"{name}/loss"], err_msg=f"rank {r}")
        np.testing.assert_allclose(got, run.single["loss"], rtol=1e-5, err_msg="one device")
        np.testing.assert_allclose(got, j["loss"], rtol=1e-5, err_msg="JAX")
    assert got[-1] < got[0]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_gradients_match_one_device_and_jax(run, name):
    """Each rank's gradient slices after step 1 (the global batch's gradient,
    after the sums over ``data`` and ``model``) against the single-device
    port's and JAX's gradient on the same mesh, cut to the rank's slice."""
    views, dims, shape = _rank_views(run, name)
    j = run.jax(shape)
    assert set(dims) == set(run.single["grad"])
    for r, m, res in views:
        for n, d in dims.items():
            got = res[f"{name}/grad/{n}"]
            for label, want in (("one device", run.single["grad"][n]), ("JAX", j["grad"][n])):
                _close_grads(got, _cut(want, d, shape[1], m), f"{name} rank {r} {n} ({label})")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_parameters_match_one_device_and_jax(run, name):
    """Each rank's parameter slices after each of the 3 steps against the
    single-device port's and JAX's on the same mesh."""
    views, dims, shape = _rank_views(run, name)
    j = run.jax(shape)
    for r, m, res in views:
        for i in range(STEPS):
            for n, d in dims.items():
                got = res[f"{name}/param{i + 1}/{n}"]
                for label, want in (("one device", run.single["params"][i][n]),
                                    ("JAX", j["params"][i][n])):
                    _close_params(got, _cut(want, d, shape[1], m), n, i + 1,
                                  f"{name} rank {r} ({label})")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_ranks_stay_bit_equal(run, name):
    """After every step the ranks of one model coordinate (the data ranks)
    hold bit-equal parameters, and every rank holds bit-equal replicated
    leaves; the split leaves' slices differ between model ranks."""
    views, dims, shape = _rank_views(run, name)
    first = {m: res for _, m, res in reversed(views)}   # the lowest rank of each coordinate
    for r, m, res in views:
        for i in range(1, STEPS + 1):
            for n, d in dims.items():
                key = f"{name}/param{i}/{n}"
                np.testing.assert_array_equal(res[key], first[m][key], err_msg=f"rank {r} {key}")
                if d < 0:
                    np.testing.assert_array_equal(res[key], views[0][2][key],
                                                  err_msg=f"rank {r} {key} (replicated)")
    if shape[1] > 1:
        split = [n for n, d in dims.items() if d >= 0]
        assert any(n.startswith("vision_tower") for n in split)
        assert all(not np.array_equal(first[0][f"{name}/param1/{n}"], first[1][f"{name}/param1/{n}"])
                   for n in split if "bias" not in n)
        kv = [n for n in dims if "language_model" in n and ("k_proj" in n or "v_proj" in n)]
        assert kv and all(dims[n] == -1 for n in kv)   # MQA: the one KV head on every rank


# -- checkpoints across layouts -------------------------------------------------------------

def _whole(ranks, prefix, dims, shape):
    """A parameter tree put back together from the ranks of data coordinate 0."""
    out = {}
    for n, d in dims.items():
        parts = [ranks[m][f"{prefix}/{n}"] for m in range(shape[1])]
        out[n] = parts[0] if d < 0 else np.concatenate(parts, axis=d)
    return out


def test_checkpoint_of_a_mesh_resumes_on_one_device(run):
    """The (2, 2) run's step-2 checkpoint restored into a single-device model
    and optimizer: its step 3 equals the mesh's uninterrupted step 3 and the
    single-device step 3 (loss rel 1e-5, parameters as the cases)."""
    views, dims, shape = _rank_views(run, W.SAVE_CASE)
    ranks = run.world(4)
    mgr = make_checkpoint_manager(run.root / "w4" / "ckpt")
    assert mgr.all_steps() == [W.SAVE_STEP]
    model = W.new_model()
    opt = make_training_setup(model, LR)
    assert restore_train_state(mgr, model, opt) == W.SAVE_STEP
    saved = torch.load(mgr.step_dir(W.SAVE_STEP) / "state.pt", weights_only=True)
    assert {n: tuple(t.shape) for n, t in saved["model"].items()} == {
        n: tuple(t.shape) for n, t in W.new_model().state_dict().items()}
    loss = float(make_train_step(model, opt)(W.torch_batch(W.tp_batch())))
    want_mesh = _whole(ranks, f"{W.SAVE_CASE}/param3", dims, shape)
    assert loss == pytest.approx(float(ranks[0][f"{W.SAVE_CASE}/loss"][2]), rel=1e-5)
    assert loss == pytest.approx(run.single["loss"][2], rel=1e-5)
    for n, p in model.named_parameters():
        for label, want in (("mesh", want_mesh[n]), ("one device", run.single["params"][2][n])):
            _close_params(p.detach().numpy(), want, n, 3, f"resumed ({label})")


def test_checkpoint_of_one_device_resumes_on_a_mesh(run):
    """The single-device step-2 checkpoint restored into a (2, 2) model on
    every rank: step 3 equals the uninterrupted single-device step 3 and the
    (2, 2) run's step 3, each rank's slices."""
    ranks = run.world(4)
    _, dims, shape = _rank_views(run, W.SAVE_CASE)
    for r, res in enumerate(ranks):
        m = _coords(r, shape)[1]
        assert int(res["resume/step"]) == W.SAVE_STEP
        assert float(res["resume/loss"][0]) == pytest.approx(run.single["loss"][2], rel=1e-5)
        for n, d in dims.items():
            got = res[f"resume/param/{n}"]
            _close_params(got, _cut(run.single["params"][2][n], d, shape[1], m), n, 3,
                          f"rank {r} (one device)")
            _close_params(got, res[f"{W.SAVE_CASE}/param3/{n}"], n, 3, f"rank {r} (mesh)")


def test_optax_state_of_a_jax_mesh_resumes_on_a_port_mesh(run):
    """JAX's (1, 2) run after step 1, its parameters and optax's Adam state
    carried into a port (1, 2) mesh (``params_from_flax`` into the whole
    model, ``adamw_state_from_optax`` cutting each rank's moments): the
    port's step 2 equals JAX's step 2."""
    j = run.jax((1, 2))
    ranks = run.world(2)
    _, dims, shape = _rank_views(run, "tp2")
    for r, res in enumerate(ranks):
        assert float(res["optax/loss"][0]) == pytest.approx(j["loss"][1], rel=1e-5)
        for n, d in dims.items():
            _close_params(res[f"optax/param/{n}"], _cut(j["params"][1][n], d, shape[1], r), n,
                          2, f"rank {r}")


# -- in-process pieces ----------------------------------------------------------------------

def _fake_mesh(tp: int, rank: int):
    """A mesh of ``tp`` model ranks seen from ``rank`` without a process
    group, for code that calls no collective (or one the caller patches)."""
    return types.SimpleNamespace(size=lambda a: tp if a == "model" else 1,
                                 index=lambda a: rank if a == "model" else 0,
                                 check=lambda t: None)


def test_tp_head_plan_lives_in_parallel_mesh():
    """``generation/engine`` takes ``tp_head_plan`` from ``parallel/mesh``, so
    training reaches it without importing the engines."""
    assert TE.tp_head_plan is TP.tp_head_plan is TP.mesh.tp_head_plan
    assert TP.tp_head_plan(TCFG.text, 4, 3) == (3, 1, 0, 1)
    assert TP.tp_head_plan(TCFG.text, 2, 1) == (2, 2, 0, 1)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_model_for_tp_takes_jax_shards(tp):
    """Each rank's weights of ``shard_model_for_tp`` are the transposes of
    the shards JAX's ``shard_params_for_tp`` places at that ``model``
    coordinate, but for Gemma's one KV head, kept whole here (JAX cuts its
    256 columns), and the column biases (whole in JAX), which are the
    matching slice. The rank's heads: 4 / tp a layer."""
    flat = _init_flat()
    jtree = _nest(flat)
    jmesh = _jmesh((1, tp))
    placed = JM.shard_params_for_tp(jtree, jmesh, axis="model")
    devs = list(jmesh.devices.reshape(-1))
    flat_j = {"/".join(getattr(k, "key", str(k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(placed)}
    for rank in range(tp):
        model = shard_model_for_tp(W.new_model(flat), _fake_mesh(tp, rank))
        assert model.vision_tower.layers[0].self_attn.heads == 4 // tp
        assert model.language_model.layers[1].self_attn.heads == 4 // tp
        plan = L.tp_plan(model)
        got = {n: p.detach().numpy() for n, p in model.named_parameters()}
        for key, jleaf in flat_j.items():
            name = convert.torch_name(key)
            shard = np.asarray(next(s for s in jleaf.addressable_shards
                                    if s.device == devs[rank]).data)
            want = convert.to_torch_layout(key, shard)
            want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
            whole = np.asarray(convert.to_torch_layout(key, flat[key]))
            if "language_model" in name and ("k_proj" in name or "v_proj" in name):
                want = whole
                assert plan[name] == (None, True)
            elif jleaf.ndim == 1 and plan.get(name, (None,))[0] == 0:
                want = np.split(whole, tp)[rank]
            np.testing.assert_array_equal(got[name], want, err_msg=f"rank {rank} {name}")


def test_a_sharded_siglip_layer_never_takes_the_fused_kernels(monkeypatch):
    """With the fused path forced on (the gate admitting every shape), a
    whole SigLIP layer goes to K5a; a rank's part of a tensor-parallel layer
    runs the unfused layer, with its two row-parallel all-reduces."""
    calls, reduced = [], []
    monkeypatch.setattr(L, "_fused_layer_enabled", lambda *a: True)
    for name in ("fused_vit_layer", "fused_vit_attention_block", "fused_mlp_block"):
        monkeypatch.setattr(FL, name, lambda *a, _n=name, **k: calls.append(_n) or a[0])
    monkeypatch.setattr(TP.mesh, "all_reduce", lambda mesh, axis, t, op="sum":
                        reduced.append(tuple(t.shape)) or t)
    model = W.new_model(_init_flat())
    layer = model.vision_tower.layers[0]
    x = torch.randn(2, 16, 32)
    layer(x)
    assert calls == ["fused_vit_layer"]
    calls.clear()
    layer.shard_(_fake_mesh(2, 1), "model")
    out = layer(x)
    assert calls == [] and out.shape == x.shape
    assert reduced == [(2, 16, 32), (2, 16, 32)]


def test_one_rank_collectives_are_identities(tmp_path):
    """On a one-rank mesh the gradient-carrying collectives return their
    input and pass the gradient through untouched."""
    with _one_rank(tmp_path) as mesh:
        x = torch.randn(3, 4, requires_grad=True)
        for fn, axis in ((TP.copy_to_model, "model"), (TP.reduce_from_model, "model"),
                         (TP.gather_rows, "data")):
            assert fn(mesh, x, axis) is x


def _one_rank(tmp_path):
    return parallel_worker.one_rank_mesh(tmp_path, ("data", "model"), (1, 1))


def test_make_train_step_needs_the_model_on_its_mesh(tmp_path):
    """A mesh step on a model ``make_training_setup`` did not put on that
    mesh raises; sharding again over the same mesh does nothing."""
    with _one_rank(tmp_path) as mesh:
        model = W.new_model()
        opt = make_training_setup(model, LR)
        with pytest.raises(ValueError, match="make_training_setup"):
            make_train_step(model, opt, mesh=mesh)
        make_training_setup(model, LR, mesh=mesh)
        assert shard_model_for_tp(model, mesh) is model and model.mesh is mesh
        with pytest.raises(ValueError, match="already on a mesh"):
            shard_model_for_tp(model, mesh, axis="data")


def test_gemma_kv_heads_split_evenly_or_stay_one():
    """2 KV heads over 2 model ranks split (one each); over 4 ranks they
    neither split nor are a single head kept whole, and the layer refuses."""
    from multimodal_colpali_tpu_torch.models.gemma import GemmaDecoderLayer

    cfg = dataclasses.replace(TCFG.text, num_key_value_heads=2)
    layer = GemmaDecoderLayer(cfg, device="cpu", dtype=torch.float32)
    layer.shard_(_fake_mesh(2, 1), "model")
    att = layer.self_attn
    assert (att.heads, att.kv_heads, att.k_proj.tp_split) == (2, 1, "col")
    assert att.k_proj.weight.shape == (cfg.head_dim, cfg.hidden_size)
    with pytest.raises(ValueError, match="KV heads evenly"):
        GemmaDecoderLayer(cfg, device="cpu", dtype=torch.float32).shard_(_fake_mesh(4, 0),
                                                                         "model")
