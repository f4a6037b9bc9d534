"""Device meshes over ``torch.distributed`` (counterpart of
``multimodal_colpali_tpu/parallel/mesh.py``).

The parallelism axes are the JAX package's (mesh.py:1-15):

- ``data``: the batch axis of page and query embedding and of the decode
  slots (DP);
- ``model``: the tensor-parallel axis of the decode engines and of
  training (TP over attention heads and the MLP's hidden units);
- ``corpus``: the page axis of the vector stores; MaxSim and top-k reduce
  over it (``ops/topk``, ``ops/two_stage``).

JAX runs one controller over every device and GSPMD inserts the collectives.
PyTorch's idiom is one process a device, so here:

- every rank runs the same host code (the same upserts, the same submits,
  the same scheduler decisions);
- each rank keeps only its shard, on its own device;
- every collective is an explicit ``torch.distributed`` call on the
  process group of one mesh axis.

Tensors stay plain (no DTensor): the hand-written kernels take plain
tensors, and each all-reduce and all-gather is visible where it happens.
The backend follows the device: NCCL for CUDA, gloo for the CPU. A CUDA
tensor on a gloo group, a CPU tensor on an NCCL group, or a mesh without an
initialised process group raises; nothing probes or falls back.

Training needs collectives with a gradient: :func:`copy_to_model` (into a
tensor-parallel region: identity, its backward an all-reduce),
:func:`reduce_from_model` (out of it: an all-reduce, its backward the
identity) and :func:`gather_rows` (every rank's rows, each rank's gradient
summed back to the rank that owns them).

Serving over a mesh has one front end: the mesh's first rank (its
``leader``) takes the requests and hands each scheduling point's admissions
to the other ranks with :func:`broadcast_object`, over a group of every rank
of the mesh (``Mesh.group``).

A collective over an axis of one rank is its input, and is not called: on
the card a one-rank NCCL all-reduce held the host until the card caught up,
which made a host-bound decode step pay its device time on top (chip_smoke
phase 17 (c) times one). A ``data`` x ``model`` mesh of (4, 1) reduces
nothing over ``model``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_colpali_tpu_torch._device import resolve_device

COL_KEYS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "query", "key", "value",
            "fc1")
ROW_KEYS = ("o_proj", "down_proj", "out_proj", "fc2", "output")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           device: Any = "cuda") -> None:
    """Join the process group (mesh.py:27-65).

    The arguments default to JAX's variables (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), then to torchrun's
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The address
    is ``host:port`` (a TCP rendezvous) or a URL (``tcp://...``,
    ``file://...``). No-op without an address, or when a group already
    exists. ``device="cuda"`` binds the rank to ``cuda:<local rank>`` (the
    first of ``local_device_ids``, else ``LOCAL_RANK``, else the rank modulo
    the card count) and joins over NCCL; ``device="cpu"`` joins over gloo."""
    if dist.is_initialized():
        return
    env = os.environ
    addr = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if addr is None:
        return  # a single-process run
    if num_processes is None:
        num_processes = int(env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("JAX_PROCESS_ID") or env.get("RANK") or 0)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_device_ids:
            local = int(local_device_ids[0])
        elif env.get("LOCAL_RANK"):
            local = int(env["LOCAL_RANK"])
        else:
            local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    url = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))


class Mesh:
    """A grid of ranks, one device each, and one process group per axis.

    ``shape`` maps each axis to its size in order, so ``mesh.shape[axis]``
    and ``mesh.shape.get(axis, 1)`` read as with a JAX mesh; ``devices``
    holds the global ranks in the mesh's shape. :meth:`index` is this rank's
    coordinate on an axis (``lax.axis_index``), :meth:`size` an axis' size
    (1 for an axis the mesh lacks, whose collectives are no-ops). ``group``
    spans every rank of the mesh; ``leader`` is its first rank."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str], groups: Dict[str, Any],
                 device: torch.device, backend: str, group: Any = None):
        self.devices = ranks
        self.group = group
        self.leader = int(ranks.flat[0])
        self.is_leader = dist.get_rank() == self.leader
        self.axis_names = tuple(axis_names)
        self.shape: "OrderedDict[str, int]" = OrderedDict(zip(self.axis_names, ranks.shape))
        coord = np.argwhere(ranks == dist.get_rank())[0]
        self.coords = {a: int(i) for a, i in zip(self.axis_names, coord)}
        self.groups = groups
        self.device = device
        self.backend = backend

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def index(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis is not None else 0

    def check(self, t: torch.Tensor) -> None:
        """Raise unless ``t`` lives where this mesh's backend communicates."""
        want = "cuda" if self.backend == "nccl" else "cpu"
        if t.device.type != want:
            raise ValueError(f"a {t.device.type} tensor on a {self.backend} group: the mesh "
                             f"communicates {want} tensors")

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank coords {self.coords}, {self.backend})"


def get_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
             devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the process group's ranks (mesh.py:86-98): by default
    every rank on the first axis; ``axis_names=("data", "model"), shape=(2,
    2)`` for DP x TP. ``devices`` orders the global ranks (default
    ``range(world_size)``); the mesh must cover the whole group, since every
    rank takes part in building each axis' groups."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: call "
                           "initialize_distributed (or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    ranks = list(devices) if devices is not None else list(range(world))
    if shape is None:
        shape = [len(ranks)] + [1] * (len(axis_names) - 1)
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axes {tuple(axis_names)}")
    if math.prod(shape) != world or sorted(ranks[:world]) != list(range(world)):
        raise ValueError(f"a mesh of shape {shape} must hold each of the {world} ranks once")
    grid = np.asarray(ranks[:world]).reshape(shape)
    me = dist.get_rank()
    groups: Dict[str, Any] = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:                  # every rank builds every group, in one order
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = g
    everyone = dist.new_group(sorted(int(r) for r in grid.flat))
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
              else torch.device("cpu"))
    return Mesh(grid, axis_names, groups, device, backend, everyone)


def global_corpus_mesh(axis: str = "corpus") -> Mesh:
    """A one-axis mesh over every rank, in rank order (mesh.py:68-71)."""
    return get_mesh((axis,))


def broadcast_object(mesh: Mesh, obj: Any, src: Optional[int] = None) -> Any:
    """``obj`` as rank ``src`` (a global rank; default the mesh's leader)
    holds it, on every rank of the mesh: pickled and sent over ``mesh.group``
    (``dist.broadcast_object_list``, its bytes a CUDA tensor on NCCL and a
    CPU one on gloo). Another rank's ``obj`` is ignored. A mesh of one rank
    returns ``obj`` and calls nothing."""
    if mesh.devices.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.leader if src is None else int(src),
                               group=mesh.group, device=mesh.device)
    return box[0]


def all_gather(mesh: Mesh, axis: Optional[str], t: torch.Tensor) -> torch.Tensor:
    """``[S, *t.shape]``: every rank's ``t`` along ``axis``, in axis order
    (``t[None]`` on an axis of one rank)."""
    mesh.check(t)
    if mesh.size(axis) == 1:
        return t[None]
    out = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    dist.all_gather(out, t.contiguous(), group=mesh.groups[axis])
    return torch.stack(out)


def all_reduce(mesh: Mesh, axis: Optional[str], t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``axis`` (``op`` "sum" or "max"); returns
    ``t`` (untouched on an axis of one rank)."""
    mesh.check(t)
    if mesh.size(axis) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=mesh.groups[axis])
    return t


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, ctx.axis, g.contiguous().clone()), None, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, axis, x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows concatenated in axis order; the backward sums the
    gathered gradient over the axis and keeps this rank's rows (an
    all-reduce and a slice: gloo has no reduce-scatter, and one code path
    serves both backends)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return torch.cat(list(all_gather(mesh, axis, x).unbind(0)))

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(ctx.mesh, ctx.axis, g.contiguous().clone())
        return g.narrow(0, ctx.mesh.index(ctx.axis) * ctx.rows, ctx.rows), None, None


def copy_to_model(mesh: Mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Enter a tensor-parallel region: ``x`` itself forward, while its
    gradient is summed over ``axis`` (each rank's heads or hidden units add
    their part). ``x`` on an axis of one rank."""
    return x if mesh.size(axis) == 1 else _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(mesh: Mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Leave a tensor-parallel region: the partial products summed over
    ``axis`` forward, the gradient passed through. ``x`` on an axis of one
    rank."""
    return x if mesh.size(axis) == 1 else _ReduceFromModel.apply(x, mesh, axis)


def gather_rows(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Every rank's rows of ``x`` along ``axis``, concatenated on dim 0, with
    the gradient each rank's rows receive from every rank's use of them
    (``x`` on an axis of one rank)."""
    return x if mesh.size(axis) == 1 else _GatherRows.apply(x, mesh, axis)


def tp_head_plan(cfg: Any, tp: int, rank: int):
    """(first query head, query heads, first KV head, KV heads) of ``rank``
    among ``tp`` model ranks. KV heads split where their count divides
    ``tp``; otherwise the rank keeps the one KV head its query heads share,
    which needs its query heads within one GQA group."""
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if hq % tp:
        raise ValueError(f"{hq} query heads do not split over {tp} model ranks")
    nq, group = hq // tp, hq // hkv
    if hkv % tp == 0:
        return rank * nq, nq, rank * (hkv // tp), hkv // tp
    if group % nq == 0:
        return rank * nq, nq, (rank * nq) // group, 1
    raise ValueError(f"{hq} query heads over {hkv} KV heads: neither the KV heads nor the "
                     f"GQA groups split over {tp} model ranks")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Dimension ``dim`` split evenly over a mesh axis (``axis=None``:
    replicated). :meth:`local` cuts a rank's part out of a global tensor,
    :meth:`gather` puts the global tensor back together from every rank's."""

    mesh: Mesh
    axis: Optional[str]
    dim: int = 0

    def bounds(self, n: int) -> Tuple[int, int]:
        size = self.mesh.size(self.axis)
        if n % size:
            raise ValueError(f"{n} rows do not split evenly over {size} ranks of "
                             f"{self.axis!r}")
        per = n // size
        lo = self.mesh.index(self.axis) * per
        return lo, lo + per

    def local(self, x):
        lo, hi = self.bounds(x.shape[self.dim])
        if isinstance(x, torch.Tensor):
            return x.narrow(self.dim, lo, hi - lo)
        return np.take(x, np.arange(lo, hi), axis=self.dim)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.size(self.axis) == 1:
            return x
        parts = all_gather(self.mesh, self.axis, x)
        return torch.cat(list(parts.unbind(0)), dim=self.dim)


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dimension over ``axis`` (mesh.py:101-103)."""
    return Sharding(mesh, axis, 0)


def replicate(mesh: Mesh) -> Sharding:
    """Every rank holds the whole tensor (mesh.py:106-107)."""
    return Sharding(mesh, None, 0)


@dataclasses.dataclass
class CorpusShard:
    """A rank's rows of a page-sharded corpus: ``local`` on the rank's device,
    its first global row ``offset`` and the global row count ``total``."""

    local: torch.Tensor
    offset: int
    total: int


def make_global_corpus(local_rows: Any, mesh: Mesh, axis: str = "corpus") -> CorpusShard:
    """This rank's rows as its shard of a corpus sharded over ``axis``
    (mesh.py:74-83): every rank contributes the same number of rows, and rank
    ``i`` of the axis holds global rows ``[i * n, (i + 1) * n)``."""
    local = (local_rows if isinstance(local_rows, torch.Tensor)
             else torch.from_numpy(np.asarray(local_rows))).to(mesh.device)
    n = local.shape[0]
    counts = all_gather(mesh, axis, torch.tensor([n], device=mesh.device))
    if bool((counts != n).any()):
        raise ValueError(f"ranks hold unequal row counts {counts.flatten().tolist()}: pad each "
                         f"to the same count with zero-length pages")
    return CorpusShard(local, mesh.index(axis) * n, n * mesh.size(axis))


def shard_range(mesh: Optional[Mesh], axis: str, n: int, multiple: int = 8
                ) -> Tuple[int, int, int]:
    """(first row, end row, padded total) of this rank's rows when ``n`` rows
    are padded to a multiple of ``multiple`` and, on a mesh, of ``axis``'
    size too (``lcm(axis size, multiple)``), then split evenly over ``axis``
    (multivector.py:111-146); without a mesh, every row."""
    if mesh is None:
        total = n + (-n) % multiple
        return 0, total, total
    total = n + (-n) % math.lcm(mesh.size(axis), multiple)
    lo, hi = Sharding(mesh, axis).bounds(total)
    return lo, hi, total


def rank_rows(arr: np.ndarray, lo: int, hi: int, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host rows ``[lo, hi)`` of ``arr`` on ``device`` (in ``dtype``), with
    zero rows for the part of the range past ``arr``'s end."""
    part = torch.from_numpy(np.ascontiguousarray(arr[lo:hi])).to(device, dtype)
    if part.shape[0] < hi - lo:
        part = torch.cat([part, part.new_zeros((hi - lo - part.shape[0],) + tuple(part.shape[1:]))])
    return part


def shard_params_for_tp(params: Any, mesh: Mesh, axis: str = "model",
                        replicated: Sequence[str] = ()) -> Any:
    """This rank's tensor-parallel slices of a parameter tree (mesh.py:112-133).

    A leaf under a column key (``COL_KEYS``) splits its output dimension: a
    2-D kernel or int8 code matrix its columns, a 1-D bias or int8 ``scale``
    its entries. A 2-D leaf under a row key (``ROW_KEYS``) splits its input
    dimension (its rows); a row-parallel bias or scale stays whole (the
    caller adds the bias once, after the all-reduce). Everything else, and
    every key named in ``replicated``, is replicated. JAX places only 2-D
    leaves; here a rank that computes a column slice also holds the matching
    slice of the layer's bias and scale."""
    size, rank = mesh.size(axis), mesh.index(axis)

    def cut(t: torch.Tensor, dim: int, name: str) -> torch.Tensor:
        n = t.shape[dim]
        if n % size:
            raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split "
                             f"over {size} ranks")
        per = n // size
        return t.narrow(dim, rank * per, per).contiguous()

    def place(path: Tuple[str, ...], t: Any) -> Any:
        if not isinstance(t, torch.Tensor) or any(k in path for k in replicated):
            return t
        name = "/".join(path)
        if any(k in path for k in COL_KEYS) and t.dim() in (1, 2):
            return cut(t, t.dim() - 1, name)
        if any(k in path for k in ROW_KEYS) and t.dim() == 2:
            return cut(t, 0, name)
        return t

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return place(path, tree)

    return walk(params, ())
