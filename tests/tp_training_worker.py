"""One rank of a gloo world for ``tests/test_torch_tp_training.py``.

Run as ``python tests/tp_training_worker.py WORLD RANK RENDEZVOUS_FILE OUT_DIR``:
the rank joins the group through ``initialize_distributed(file://...)``,
trains the tiny tensor-parallel ColPali of :func:`tp_cfg` on every
``data`` x ``model`` mesh of its world size (:data:`CASES`) and writes to
``OUT_DIR/rank<RANK>.npz`` each case's losses, its gradient slices after
step 1, its parameter slices after every step and each parameter's split
dimension. The starting parameters (``OUT_DIR/../init.npz``), the
single-device checkpoint a world of 4 resumes and the optax state a world of
2 resumes are written by the test before the world starts. This module
imports torch and the port only.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 3
# name -> ((data, model), remat); a world runs the cases of its size
CASES = {2: {"dp2": ((2, 1), False), "tp2": ((1, 2), False)},
         4: {"dp2tp2": ((2, 2), False), "dp4": ((4, 1), False), "tp4": ((1, 4), False),
             "dp2tp2_remat": ((2, 2), True)}}
SAVE_CASE, SAVE_STEP = "dp2tp2", 2     # the mesh run whose step 2 the test resumes on one device


def tp_cfg():
    """Tiny ColPali with 4 SigLIP heads, 4 Gemma query heads over 1 KV head
    and intermediate sizes that split over 4 ranks, a 56-px tower (16
    patches)."""
    from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig

    t = ColPaliModelConfig.tiny()
    return dataclasses.replace(
        t, vision=dataclasses.replace(t.vision, num_attention_heads=4, image_size=56),
        text=dataclasses.replace(t.text, num_attention_heads=4))


def tp_batch(seed: int = 1, b: int = 4):
    """numpy inputs: 4 queries with trailing padding, 4 pages of 16 image
    tokens and a 4-token prompt, two of them padded."""
    rng = np.random.default_rng(seed)
    n_img, image_token = 16, 63
    q_mask = np.ones((b, 8), np.int32)
    q_mask[1, 5:] = 0
    q_mask[3, 2:] = 0
    d_ids = np.zeros((b, n_img + 4), np.int32)
    d_ids[:, :n_img] = image_token
    d_ids[:, n_img:] = rng.integers(3, 60, (b, 4))
    d_mask = np.ones_like(d_ids)
    d_mask[1, -2:] = 0
    d_mask[2, -1:] = 0
    return {
        "query_ids": rng.integers(3, 60, (b, 8)).astype(np.int32) * q_mask,
        "query_mask": q_mask,
        "doc_ids": d_ids,
        "doc_mask": d_mask,
        "doc_pixels": rng.uniform(-1, 1, (b, 56, 56, 3)).astype(np.float32),
    }


def torch_batch(batch):
    import torch

    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def load_flat(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def new_model(flat=None):
    """The port's tiny model on the CPU in float32, from a flat flax tree."""
    import torch

    from multimodal_colpali_tpu_torch.models import convert
    from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel

    model = ColPaliModel(tp_cfg(), device="cpu", dtype=torch.float32)
    if flat is not None:
        model.load_state_dict(convert.params_from_flax(flat, tp_cfg()))
    return model


def split_dims(model) -> dict:
    """name -> the dimension a rank's slice is cut on, -1 for a whole leaf."""
    from multimodal_colpali_tpu_torch.models.layers import tp_plan

    plan = tp_plan(model) if model.mesh.size(model.tp_axis) > 1 else {}
    return {n: -1 if plan.get(n, (None,))[0] is None else plan[n][0]
            for n, _ in model.named_parameters()}


def _snapshot(res, prefix, model, what="param"):
    for n, p in model.named_parameters():
        t = p if what == "param" else p.grad
        res[f"{prefix}/{n}"] = t.detach().numpy().copy()


def run_case(res, name, shape, remat, init, batch, ckpt_dir):
    """``STEPS`` steps of the mesh path; the SAVE_CASE saves its step 2."""
    from multimodal_colpali_tpu_torch.parallel import get_mesh
    from multimodal_colpali_tpu_torch.training import make_train_step, make_training_setup
    from multimodal_colpali_tpu_torch.training.checkpoint import (make_checkpoint_manager,
                                                                   save_train_state)

    mesh = get_mesh(("data", "model"), shape)
    model = new_model(init)
    opt = make_training_setup(model, LR, mesh=mesh)
    step = make_train_step(model, opt, mesh=mesh, remat=remat)
    losses = []
    for i in range(1, STEPS + 1):
        losses.append(float(step(batch)))
        if i == 1:
            _snapshot(res, f"{name}/grad", model, "grad")
        _snapshot(res, f"{name}/param{i}", model)
        if name == SAVE_CASE and i == SAVE_STEP:
            save_train_state(make_checkpoint_manager(ckpt_dir), i, model, opt)
    res[f"{name}/loss"] = np.array(losses)
    for n, d in split_dims(model).items():
        res[f"{name}/dim/{n}"] = np.array(d)


def resume_from_one_device(res, ckpt_dir, batch):
    """The test's single-device step-2 checkpoint restored into a (2, 2)
    model: step 3's loss and parameters."""
    from multimodal_colpali_tpu_torch.parallel import get_mesh
    from multimodal_colpali_tpu_torch.training import make_train_step, make_training_setup
    from multimodal_colpali_tpu_torch.training.checkpoint import (make_checkpoint_manager,
                                                                   restore_train_state)

    mesh = get_mesh(("data", "model"), (2, 2))
    model = new_model()
    opt = make_training_setup(model, LR, mesh=mesh)
    res["resume/step"] = np.array(restore_train_state(make_checkpoint_manager(ckpt_dir),
                                                      model, opt))
    res["resume/loss"] = np.array([float(make_train_step(model, opt, mesh=mesh)(batch))])
    _snapshot(res, "resume/param", model)


def resume_optax(res, path, batch):
    """A JAX (1, 2) mesh run after step 1 (its parameters, and optax's
    count, mu and nu, whole) continued by a port (1, 2) mesh: step 2."""
    from multimodal_colpali_tpu_torch.parallel import get_mesh
    from multimodal_colpali_tpu_torch.training import make_train_step, make_training_setup
    from multimodal_colpali_tpu_torch.training.trainer import adamw_state_from_optax

    flat = load_flat(path)
    tree = {part: {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith(part + "/")}
            for part in ("params", "mu", "nu")}
    mesh = get_mesh(("data", "model"), (1, 2))
    model = new_model(tree["params"])
    opt = make_training_setup(model, LR, mesh=mesh)
    adam = types.SimpleNamespace(count=flat["count"], mu=tree["mu"], nu=tree["nu"])
    opt.state.update(adamw_state_from_optax((adam,), model))
    res["optax/loss"] = np.array([float(make_train_step(model, opt, mesh=mesh)(batch))])
    _snapshot(res, "optax/param", model)


def main(world: int, rank: int, rendezvous: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from multimodal_colpali_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"file://{rendezvous}", world, rank, device="cpu")
    root = Path(out_dir).parent
    init = load_flat(root / "init.npz")
    batch = torch_batch(tp_batch())
    res = {}
    for name, (shape, remat) in CASES[world].items():
        run_case(res, name, shape, remat, init, batch, Path(out_dir) / "ckpt")
    if world == 4:
        resume_from_one_device(res, root / "ckpt_single", batch)
    else:
        resume_optax(res, root / "optax.npz", batch)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
