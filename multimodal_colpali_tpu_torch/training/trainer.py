"""ColPali contrastive training (counterpart of ``multimodal_colpali_tpu/training/trainer.py``).

The late-interaction objective ColPali-family retrievers are trained with
(in-batch negatives over the MaxSim score matrix, the "ColBERT loss") and an
AdamW step on one device:

- :func:`colbert_loss` - trainer.py:32-52, plain ``torch`` (an einsum in
  JAX as well, not K1).
- :func:`make_training_setup` - trainer.py:104-119: makes the model's
  floating parameters trainable and builds ``torch.optim.AdamW`` with
  ``optax.adamw``'s defaults (weight decay 1e-4 on every leaf, betas (0.9,
  0.999), eps 1e-8).
- :func:`make_train_step` - trainer.py:55-101: one step on a batch returns
  the loss and updates the model and the optimizer in place;
  ``remat=True`` recomputes each of the two forwards in the backward pass
  (``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps ``fwd``).
- :func:`adamw_state_from_optax` - optax's Adam moments and count carried
  over into the port's AdamW state, so that a JAX run resumes here.

The forward runs in the model's dtype; the JAX trainer's numerics are
float32 (``fast_random_params`` gives float32 leaves and it never casts),
and on the card SigLIP's attention is K2 with its backward kernel, which
take float32 only (``ops/attention.fused_attention``).

A mesh (DP x TP, trainer.py:88-101) raises ``NotImplementedError``: the
data-parallel step must score every rank's queries against all the gathered
pages (``colbert_loss`` is in-batch), which is the next slice (ROADMAP.md
queue 1, item 2.4).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from multimodal_colpali_tpu_torch.models.convert import state_from_flax
from multimodal_colpali_tpu_torch.models.layers import set_trainable

NEG = -1e30
# optax.adamw's defaults (b1, b2, eps, weight_decay), not torch's 0.01 decay
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def colbert_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, q_mask: torch.Tensor,
                 d_mask: torch.Tensor) -> torch.Tensor:
    """In-batch contrastive cross-entropy over the MaxSim score matrix.

    ``q_emb [B, NQ, DIM]`` (L2-normalized, masked rows zeroed), ``d_emb
    [B, NT, DIM]``, masks ``[B, N]`` (1 = valid). The float32 similarity
    ``[B, C, NQ, NT]`` takes -1e30 on padded page tokens, its max over page
    tokens is summed over valid query tokens, and the diagonal pairs are the
    positives. ``amax`` splits the gradient of tied maxima evenly, as
    ``jnp.max`` does."""
    sim = torch.einsum("bqd,ctd->bcqt", q_emb.float(), d_emb.float())
    sim = sim.masked_fill(~d_mask.bool()[None, :, None, :], NEG)
    per_q = sim.amax(dim=-1) * q_mask[:, None, :].float()  # [B, C, NQ]
    scores = per_q.sum(dim=-1)                               # [B, C]
    labels = torch.arange(scores.shape[0], device=scores.device)
    return F.cross_entropy(scores, labels)


def _refuse_mesh(mesh: Any, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...): DP x TP training is not ported yet (ROADMAP.md queue 1, "
            "item 2.4); the port trains on one device")


def make_training_setup(model: torch.nn.Module, learning_rate: float = 1e-4,
                        mesh: Any = None) -> torch.optim.AdamW:
    """Make ``model``'s floating parameters trainable and return its AdamW
    optimizer (``optax.adamw(learning_rate)``'s settings)."""
    _refuse_mesh(mesh, "make_training_setup")
    set_trainable(model)
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh: Any = None,
                    remat: bool = False) -> Callable[[Mapping[str, torch.Tensor]], torch.Tensor]:
    """Build ``step(batch) -> loss``: the ColBERT loss of the query and page
    forwards, its gradient, one optimizer step (model and optimizer change
    in place); the returned loss is a detached 0-d float32 tensor.

    ``batch`` keys: ``query_ids``/``query_mask`` ``[B, SQ]``;
    ``doc_ids``/``doc_mask`` ``[B, SD]``; ``doc_pixels`` ``[B, H, W, 3]``
    (normalized, in the model's dtype), on the model's device.

    ``remat=True`` keeps only each forward's inputs and recomputes the
    forward in the backward pass: activations of a 3B encoder over
    ~1,030-token pages dominate training memory, and the extra forward
    trades compute for it."""
    _refuse_mesh(mesh, "make_train_step")

    def fwd(ids, mask, pixels):
        return model(ids, mask, pixels)

    def forward(ids, mask, pixels):
        if remat:
            return checkpoint(fwd, ids, mask, pixels, use_reentrant=False)
        return fwd(ids, mask, pixels)

    def step(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        q_emb = forward(batch["query_ids"], batch["query_mask"], None)
        d_emb = forward(batch["doc_ids"], batch["doc_mask"], batch["doc_pixels"])
        loss = colbert_loss(q_emb, d_emb, batch["query_mask"], batch["doc_mask"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def adamw_state_from_optax(opt_state: Any,
                           model: torch.nn.Module) -> Dict[torch.nn.Parameter, Dict[str, Any]]:
    """optax's Adam state (the ``ScaleByAdamState`` inside ``opt_state``:
    ``count``, and ``mu`` / ``nu`` in the flax layout of the params) -> the
    AdamW state of ``model``'s parameters, on their device and in their
    dtype, keyed as ``optimizer.state`` is:
    ``optimizer.state.update(adamw_state_from_optax(opt_state, model))``.
    With the weights carried by ``models/convert.params_from_flax``, the
    next port step continues the JAX run."""
    adam = _adam_state(opt_state)
    mu = state_from_flax(adam.mu, model)
    nu = state_from_flax(adam.nu, model)
    step = float(np.asarray(adam.count))
    state = {}
    for name, p in model.named_parameters():
        state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
                    "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype)}
    return state


def _adam_state(opt_state: Any) -> Any:
    """The first node of an optax state tree with ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            try:
                return _adam_state(part)
            except ValueError:
                continue
    raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
