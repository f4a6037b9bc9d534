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
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from pathlib import Path
from typing import List, Optional, Union

import torch

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


def save_train_state(mgr: CheckpointManager, step: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> None:
    """Save ``step``'s model and optimizer state atomically (a step saved
    again is replaced), then drop all but the newest ``max_to_keep`` steps."""
    step = int(step)
    if step < 0:
        raise ValueError(f"step must be >= 0, got {step}")
    tmp = mgr.directory / f".tmp-{step}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}, tmp / STATE_FILE)
    final = mgr.step_dir(step)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in mgr.all_steps()[:-mgr.max_to_keep]:
        shutil.rmtree(mgr.step_dir(old), ignore_errors=True)


def restore_train_state(mgr: CheckpointManager, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, step: Optional[int] = None) -> int:
    """Load a saved step (the latest by default) into ``model`` and
    ``optimizer`` -> the step."""
    step = mgr.latest_step() if step is None else int(step)
    path = None if step is None else mgr.step_dir(step) / STATE_FILE
    if path is None or not path.is_file():
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"under {mgr.directory}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
