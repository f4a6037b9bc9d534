"""ColPali contrastive training (counterpart of ``multimodal_colpali_tpu/training/trainer.py``).

The late-interaction objective ColPali-family retrievers are trained with
(in-batch negatives over the MaxSim score matrix, the "ColBERT loss") and an
AdamW step, on one device or on a ``data`` x ``model`` mesh:

- :func:`colbert_loss` - trainer.py:32-52, plain ``torch`` (an einsum in
  JAX as well, not K1); :func:`colbert_scores` is its score matrix.
- :func:`make_training_setup` - trainer.py:104-119: on a mesh, makes the
  model this rank's part of a tensor-parallel ColPali over ``model``
  (``models/colpali.shard_model_for_tp``); then makes its floating
  parameters trainable and builds ``torch.optim.AdamW`` over them with
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

On a mesh (trainer.py:88-101) every rank is handed the global batch, as
JAX's controller is, and keeps its rows on ``data``. The ColBERT loss is
in-batch over the global batch, so a rank gathers every rank's page
embeddings (``parallel.gather_rows``, whose backward returns each rank the
gradient all ranks' queries send its pages), scores its own queries against
all pages with labels at its rows' global offset, and sums its rows'
cross-entropy over the global batch size. After the backward each gradient
is summed over ``data`` (and, for a K/V projection every model rank keeps
whole, over ``model`` too), so every rank steps with the global gradient
and data ranks stay equal; the returned loss is the global one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from multimodal_colpali_tpu_torch.models.colpali import shard_model_for_tp
from multimodal_colpali_tpu_torch.models.convert import state_from_flax
from multimodal_colpali_tpu_torch.models.layers import set_trainable, tp_plan
from multimodal_colpali_tpu_torch.parallel.mesh import all_reduce, batch_sharding, gather_rows
from multimodal_colpali_tpu_torch.training.checkpoint import rank_state, whole_module

NEG = -1e30
# optax.adamw's defaults (b1, b2, eps, weight_decay), not torch's 0.01 decay
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def colbert_scores(q_emb: torch.Tensor, d_emb: torch.Tensor, q_mask: torch.Tensor,
                   d_mask: torch.Tensor) -> torch.Tensor:
    """The MaxSim score matrix ``[Bq, C]`` of the ColBERT loss: query ``b``
    against page ``c``. ``q_emb [Bq, NQ, DIM]`` (L2-normalized, masked rows
    zeroed), ``d_emb [C, NT, DIM]``, masks ``[Bq, NQ]`` / ``[C, NT]`` (1 =
    valid). The float32 similarity ``[Bq, C, NQ, NT]`` takes -1e30 on padded
    page tokens, and its max over page tokens is summed over valid query
    tokens. ``amax`` splits the gradient of tied maxima evenly, as
    ``jnp.max`` does."""
    sim = torch.einsum("bqd,ctd->bcqt", q_emb.float(), d_emb.float())
    sim = sim.masked_fill(~d_mask.bool()[None, :, None, :], NEG)
    per_q = sim.amax(dim=-1) * q_mask[:, None, :].float()  # [B, C, NQ]
    return per_q.sum(dim=-1)                                 # [B, C]


def colbert_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, q_mask: torch.Tensor,
                 d_mask: torch.Tensor) -> torch.Tensor:
    """In-batch contrastive cross-entropy over :func:`colbert_scores` ``[B,
    B]``: the diagonal pairs are the positives."""
    scores = colbert_scores(q_emb, d_emb, q_mask, d_mask)
    labels = torch.arange(scores.shape[0], device=scores.device)
    return F.cross_entropy(scores, labels)


def make_training_setup(model: torch.nn.Module, learning_rate: float = 1e-4,
                        mesh: Any = None, tp_axis: str = "model") -> torch.optim.AdamW:
    """Make ``model``'s floating parameters trainable and return its AdamW
    optimizer (``optax.adamw(learning_rate)``'s settings).

    With a ``mesh`` (``parallel.get_mesh``, the model on its device) the
    model first becomes this rank's part of a tensor-parallel model over
    ``tp_axis`` (``shard_model_for_tp``: the parameters are replaced by the
    rank's slices, and the mesh recorded on the model; an axis of one rank
    cuts nothing), so the optimizer holds the rank's own parameters."""
    if mesh is not None:
        shard_model_for_tp(model, mesh, tp_axis)
    set_trainable(model)
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh: Any = None,
                    data_axis: str = "data",
                    remat: bool = False) -> Callable[[Mapping[str, torch.Tensor]], torch.Tensor]:
    """Build ``step(batch) -> loss``: the ColBERT loss of the query and page
    forwards, its gradient, one optimizer step (model and optimizer change
    in place); the returned loss is a detached 0-d float32 tensor.

    ``batch`` keys: ``query_ids``/``query_mask`` ``[B, SQ]``;
    ``doc_ids``/``doc_mask`` ``[B, SD]``; ``doc_pixels`` ``[B, H, W, 3]``
    (normalized, in the model's dtype), on the model's device.

    With a ``mesh`` (the one ``make_training_setup`` put the model on) every
    rank passes the global batch, ``B`` a multiple of the ``data_axis``
    size; the rank runs its rows (``batch_sharding(mesh).local``) and the
    loss and the update are the global batch's (see the module's doc).

    ``remat=True`` keeps only each forward's inputs and recomputes the
    forward in the backward pass: activations of a 3B encoder over
    ~1,030-token pages dominate training memory, and the extra forward
    trades compute for it. On a mesh the recomputed forward runs its
    collectives again, in the same order on every rank."""
    if mesh is not None and getattr(model, "mesh", None) is not mesh:
        raise ValueError("make_train_step(mesh=...) needs the model on that mesh: call "
                         "make_training_setup(model, mesh=mesh) first")

    def fwd(ids, mask, pixels):
        return model(ids, mask, pixels)

    def forward(ids, mask, pixels):
        if remat:
            return checkpoint(fwd, ids, mask, pixels, use_reentrant=False)
        return fwd(ids, mask, pixels)

    def step(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            q_emb = forward(batch["query_ids"], batch["query_mask"], None)
            d_emb = forward(batch["doc_ids"], batch["doc_mask"], batch["doc_pixels"])
            loss = colbert_loss(q_emb, d_emb, batch["query_mask"], batch["doc_mask"])
            loss.backward()
            optimizer.step()
            return loss.detach()
        rows = batch_sharding(mesh, data_axis)
        mine = {k: rows.local(v) for k, v in batch.items()}
        q_emb = forward(mine["query_ids"], mine["query_mask"], None)
        d_emb = forward(mine["doc_ids"], mine["doc_mask"], mine["doc_pixels"])
        scores = colbert_scores(q_emb, gather_rows(mesh, d_emb, data_axis), mine["query_mask"],
                                batch["doc_mask"])
        first, end = rows.bounds(batch["query_ids"].shape[0])
        labels = torch.arange(first, end, device=scores.device)
        loss = F.cross_entropy(scores, labels, reduction="sum") / batch["query_ids"].shape[0]
        loss.backward()
        sum_gradients(model, mesh, data_axis)
        optimizer.step()
        return all_reduce(mesh, data_axis, loss.detach().clone())

    return step


def sum_gradients(model: torch.nn.Module, mesh: Any, data_axis: str = "data") -> None:
    """Each rank's gradients -> the global batch's, in place, parameter by
    parameter in the model's order (the same collectives in the same order
    on every rank): a projection kept whole on every model rank
    (``layers.tp_plan``'s K/V of one KV head) summed over the model axis,
    then every gradient over ``data_axis``."""
    summed = {n for n, (_, over_model) in tp_plan(model).items() if over_model}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        if name in summed:
            all_reduce(mesh, model.tp_axis, p.grad)
        all_reduce(mesh, data_axis, p.grad)


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
    mu, nu = (rank_state(state_from_flax(t, whole_module(model)), model) for t in (adam.mu, adam.nu))
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
