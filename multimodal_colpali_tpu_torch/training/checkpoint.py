"""Training checkpoints (counterpart of ``multimodal_colpali_tpu/training/checkpoint.py``).

The JAX package saves with orbax; the card's machine has neither orbax nor
safetensors, so a step is one ``torch.save`` file of the model's and the
optimizer's state dicts, ``<directory>/<step>/state.pt``:

- a save writes into a temporary directory beside the steps and renames it
  into place, so a step directory is whole or absent; a leftover temporary
  directory (a save that died) is never taken for a step;
- only the newest ``max_to_keep`` steps are kept;
- a restore takes the latest step unless told one, raises
  ``FileNotFoundError`` when there is none, and puts every tensor back on
  the model's device (the optimizer's step counts stay on the host, as a
  fresh ``AdamW`` keeps them).

One format serves every mesh layout, as orbax writes global arrays and
restores into sharded like-trees (checkpoint.py:22-42). On a model that
``make_training_setup(mesh=)`` put on a mesh, a save gathers each
tensor-parallel parameter and its AdamW moments over the model axis
(``layers.tp_plan``), the mesh's first rank writes the same ``state.pt`` a
single-device run writes, and every rank waits for it at a barrier; a
restore into such a model cuts each rank's slices out of the whole tensors.
So a step saved by a (2, 2) mesh resumes on one device, and the reverse.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist

from multimodal_colpali_tpu_torch.models.layers import tp_plan
from multimodal_colpali_tpu_torch.parallel.mesh import Sharding

STATE_FILE = "state.pt"


@dataclasses.dataclass
class CheckpointManager:
    directory: Path
    max_to_keep: int = 3

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first (directories named by a number)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / STATE_FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> Path:
        return self.directory / str(step)


def make_checkpoint_manager(directory: Union[str, os.PathLike],
                            max_to_keep: int = 3) -> CheckpointManager:
    if max_to_keep < 1:
        raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    return CheckpointManager(path, max_to_keep)


def _split_dims(model: torch.nn.Module) -> Dict[str, int]:
    """``{parameter name: split dim}`` of a tensor-parallel model's sliced
    parameters (empty off a mesh, or on a model axis of one rank)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.size(model.tp_axis) == 1:
        return {}
    return {n: dim for n, (dim, _) in tp_plan(model).items() if dim is not None}


def whole_module(model: torch.nn.Module) -> torch.nn.Module:
    """``model``, or for a tensor-parallel one its whole counterpart on the
    meta device (the shapes a whole state has)."""
    return type(model)(model.cfg, device="meta") if _split_dims(model) else model


def rank_state(state: Dict[str, torch.Tensor], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Whole tensors by parameter name -> this rank's slices of ``model``'s
    split parameters (the rest as given)."""
    dims = _split_dims(model)
    return {n: Sharding(model.mesh, model.tp_axis, dims[n]).local(t).clone()
            if n in dims else t for n, t in state.items()}


def whole_state(state: Dict[str, torch.Tensor], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's slices by parameter name -> the whole tensors, gathered
    over the model axis (a collective: every rank calls it, in one order)."""
    dims = _split_dims(model)
    return {n: Sharding(model.mesh, model.tp_axis, dims[n]).gather(t) if n in dims else t
            for n, t in state.items()}


def _param_names(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The parameter name of each index of the optimizer's state dict."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _moments(opt_state: dict, names: List[str], fn, model) -> dict:
    """``opt_state`` with its AdamW moments mapped by ``fn(state by name,
    model)`` (the step counts as they are)."""
    out = {"param_groups": opt_state["param_groups"], "state": {}}
    for key in ("exp_avg", "exp_avg_sq"):
        by_name = fn({names[i]: st[key] for i, st in opt_state["state"].items()}, model)
        for i, st in opt_state["state"].items():
            out["state"].setdefault(i, dict(st))[key] = by_name[names[i]]
    return out


def save_train_state(mgr: CheckpointManager, step: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> None:
    """Save ``step``'s model and optimizer state atomically (a step saved
    again is replaced), then drop all but the newest ``max_to_keep`` steps.
    On a mesh every rank calls it: the whole state is gathered, the mesh's
    first rank writes, and all ranks return after the write."""
    step = int(step)
    if step < 0:
        raise ValueError(f"step must be >= 0, got {step}")
    model_state, opt_state = model.state_dict(), optimizer.state_dict()
    mesh = getattr(model, "mesh", None)
    if _split_dims(model):
        model_state = whole_state(model_state, model)
        opt_state = _moments(opt_state, _param_names(model, optimizer), whole_state, model)
    if mesh is None or int(mesh.devices.flat[0]) == dist.get_rank():
        tmp = mgr.directory / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"step": step, "model": model_state, "optimizer": opt_state},
                   tmp / STATE_FILE)
        final = mgr.step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in mgr.all_steps()[:-mgr.max_to_keep]:
            shutil.rmtree(mgr.step_dir(old), ignore_errors=True)
    if mesh is not None and mesh.devices.size > 1:
        dist.barrier()


def restore_train_state(mgr: CheckpointManager, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, step: Optional[int] = None) -> int:
    """Load a saved step (the latest by default) into ``model`` and
    ``optimizer`` -> the step. A step saved on any mesh layout, or on one
    device, loads into a model on any other: a tensor-parallel model takes
    its rank's slices."""
    step = mgr.latest_step() if step is None else int(step)
    path = None if step is None else mgr.step_dir(step) / STATE_FILE
    if path is None or not path.is_file():
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"under {mgr.directory}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model_state, opt_state = state["model"], state["optimizer"]
    if _split_dims(model):
        model_state = rank_state(model_state, model)
        opt_state = _moments(opt_state, _param_names(model, optimizer), rank_state, model)
    model.load_state_dict(model_state)
    optimizer.load_state_dict(opt_state)
    return int(state["step"])
