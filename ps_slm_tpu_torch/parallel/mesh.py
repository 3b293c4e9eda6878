"""The device mesh and its sharding rules over ``torch.distributed``.

Counterpart of ``ps_slm_tpu/parallel/mesh.py``.  One process drives one
device, and the processes form a mesh with the JAX package's axes, in its
order:

  pipe    GPipe over the LLM's layer stack (``parallel/pipeline.py``)
  data    data parallelism: the parameters replicated
  fsdp    FSDP: parameters and optimizer state sharded (FSDP2's
          ``fully_shard``); the batch is split over data x fsdp together
  tensor  Megatron column / row parallelism of the LLM's, the encoder's
          and the projectors' projections, the vocabulary rows of the table
          (``parallel/tensor.py``, by hand)

The placement rules (:func:`_tp_spec`, :func:`_param_spec`,
:func:`param_shardings`) are the JAX package's, pure Python over a leaf's
JAX name path and shape; :func:`jax_leaf` reads the port's parameter names
through ``convert.py``'s name map (stacked layer axes, transposed linear
kernels, the FSMN and cov1d kernels' axis order), and
:func:`torch_placements` turns each JAX spec back into the port's layout.

:func:`shard_params` applies them.  Each process holds its blocks as
plain tensors and the modules call the collectives (the JAX package's
GSPMD partitions any op): over ``tensor`` a column-parallel projection
keeps its bias's block with its kernel's, and the encoder's fused ``qkv``
is held by heads (q, k and v of each rank's heads, where the JAX spec's
contiguous block of its ``[in, 3 d]`` kernel splits q, k and v by
thirds); :meth:`Parallel.whole`, :func:`gathered` and the train state give
the whole tensors back in the one-process layout.  FSDP2 gathers each
transformer block and the projector as a unit, the rest with the model;
leaves the rule replicates are left to the model (``ignored_params``) and
their gradients summed here.  ``pipe`` composes with ``data``, ``fsdp``
and ``tensor``: each stage keeps its own L/P layers (the JAX rule's
``spec[0] = "pipe"``), frees the others' parameters and buffers
(``Parallel.freed``) and shards its own within the stage; what lies
outside the layer stack stays replicated over ``pipe``, and every stage
computes the same gradients for it, so nothing is summed over ``pipe``.

What stays different from the JAX package: the cross-attention
projector gathers the vocabulary-sharded table whole on every rank once
a forward (``models/tasu.py::_project``), and between cards only gloo
has run: NCCL is untried.

The JAX forward's layout hints (``_batch_sharded``,
``_fsdp_gathered_table`` in ``ps_slm_tpu/models/tasu.py``) steer GSPMD's
choices; eager PyTorch makes no such choice, so they have no counterpart.

The loss is the mean over the global batch's labelled tokens: each process
divides its summed NLL by the global count (``Parallel.batch_sum``), and
the gradients are summed, never averaged (FSDP2's divide factor is 1).
Every process keeps the same generator and draws at the global batch's
shape, keeping its own block of rows (``Parallel.row_block``), so the
draws are one process's whatever the mesh.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ps_slm_tpu_torch.ops import RowBlock

AXES = ("pipe", "data", "fsdp", "tensor")
BATCH_AXES = ("data", "fsdp")
Spec = Tuple[Optional[str], ...]


# ----------------------------------------------------------------------------
# the process group
# ----------------------------------------------------------------------------

def init_distributed(device="cuda") -> Tuple[int, int]:
    """Join the process group that ``PS_COORDINATOR`` (``host:port``),
    ``PS_NUM_HOSTS`` and ``PS_HOST_ID`` describe and return (world size,
    rank).  The backend is ``nccl`` for CUDA and ``gloo`` for the CPU, or
    ``PS_DIST_BACKEND``; ranks that share one card need ``gloo`` (NCCL
    refuses two ranks on one device, so that raises here).  A CUDA rank
    takes card ``rank % device_count``.  Without a coordinator nothing
    starts: (1, 0)."""
    n = int(os.environ.get("PS_NUM_HOSTS", "1"))
    coord = os.environ.get("PS_COORDINATOR")
    if coord is None:
        if n > 1:
            raise ValueError("PS_NUM_HOSTS > 1 needs PS_COORDINATOR (host:port)")
        return 1, 0
    rank = int(os.environ.get("PS_HOST_ID", "0"))
    if not 0 <= rank < n:
        raise ValueError(f"PS_HOST_ID {rank} is outside [0, {n})")
    dev = torch.device(device)
    backend = os.environ.get("PS_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and n > count:
            raise ValueError(
                f"{n} ranks over NCCL on {count} card(s): NCCL refuses two ranks on one "
                "device; set PS_DIST_BACKEND=gloo to share a card")
        torch.cuda.set_device(rank % count)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", rank=rank, world_size=n)
    return n, rank


def mesh_dims(mesh_shape: Optional[dict], n: int) -> Dict[str, int]:
    """The mesh's axis sizes over ``n`` devices: the JAX ``build_mesh``'s
    defaults (every device on ``data``) and its ``ValueError``."""
    if not mesh_shape:
        mesh_shape = {"data": n}
    shape = {"pipe": 1, "data": 1, "fsdp": 1, "tensor": 1}
    shape.update(mesh_shape)
    total = shape["pipe"] * shape["data"] * shape["fsdp"] * shape["tensor"]
    if total != n:
        raise ValueError(f"mesh {shape} needs {total} devices, have {n}")
    return shape


def build_mesh(mesh_shape: Optional[dict] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group's ranks with the axes
    ``("pipe", "data", "fsdp", "tensor")``, rank r at the row-major index r,
    as the JAX mesh reshapes its devices."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = mesh_dims(mesh_shape, dist.get_world_size())
    ranks = torch.arange(dist.get_world_size()).reshape(*(shape[a] for a in AXES))
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


# ----------------------------------------------------------------------------
# the placement rules (pure Python; the JAX package's)
# ----------------------------------------------------------------------------

# Megatron-style tensor-parallel rules for transformer projections:
# column-parallel (out-features sharded) for q/k/v/gate/up + embeddings,
# row-parallel (in-features sharded) for o/down.
_TP_COL = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "qkv", "w1",
           "ffn1"}
_TP_ROW = {"o_proj", "down_proj", "out", "w2", "ffn2"}


def _tp_spec(path_keys, shape, tensor_size: int):
    """Return (dim, axis) tensor-parallel placement or None."""
    names = {str(k) for k in path_keys}
    if "embed_tokens" in names:
        dim = 0                                     # vocab rows
    elif "lm_head" in names:
        dim = len(shape) - 1                        # vocab cols
    elif "kernel" in names and names & _TP_COL:
        dim = len(shape) - 1                        # out features
    elif "kernel" in names and names & _TP_ROW:
        dim = len(shape) - 2                        # in features
    else:
        return None
    if dim >= 0 and shape[dim] % tensor_size == 0:
        return dim, "tensor"
    return None


def _param_spec(
    path_keys, shape, fsdp_size: int, min_size: int, tensor_size: int = 1,
    pipe_size: int = 1,
) -> Spec:
    """The JAX sharding rule as a tuple of axis names (None: not sharded),
    one entry a dimension: the stacked LLM layer axis over ``pipe``, then
    the tensor-parallel placement, then FSDP on the largest remaining
    dimension divisible by ``fsdp_size`` of a leaf with >= ``min_size``
    elements (never a stacked leaf's layer axis, never the FSMN kernels)."""
    names = {str(k) for k in path_keys}
    llm_stacked = "layers" in names and not (names & {"projector", "encoder"})
    spec: List[Optional[str]] = [None] * len(shape)
    if pipe_size > 1 and llm_stacked and len(shape) > 1 and shape[0] % pipe_size == 0:
        spec[0] = "pipe"
    if tensor_size > 1 and int(np.prod(shape)) >= min_size:
        tp = _tp_spec(path_keys, shape, tensor_size)
        if tp is not None and spec[tp[0]] is None:
            spec[tp[0]] = tp[1]
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return tuple(spec)
    if "fsmn" in names:
        # depthwise-conv kernels: replicated (the JAX rule's reasons)
        return tuple(spec)
    stacked = any(str(k) == "layers" for k in path_keys)
    start = 1 if (stacked and len(shape) > 1) else 0
    best, best_size = None, 0
    for i in range(start, len(shape)):
        if spec[i] is None and shape[i] % fsdp_size == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is not None:
        spec[best] = "fsdp"
    return tuple(spec)


_LLM_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
_ENC_LINEARS = ("qkv", "out", "w1", "w2", "ctc_lo")
_STACKS = {("encoder", "encoders"), ("encoder", "tp_encoders"), ("llm", "layers")}


class JaxLeaf(NamedTuple):
    """Where a port tensor sits in the JAX parameter tree."""

    path: Tuple            # JAX keys (an int: a list index)
    layer: Optional[int]   # the index on a stacked leaf's layer axis
    shape: Tuple[int, ...]  # the JAX leaf's shape, without the layer axis
    dims: Tuple[int, ...]  # dims[j]: the port's dimension of JAX dimension j


def _linear_leaf(leaf: str, shape) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    """An ``nn.Linear`` entry -> (JAX leaf name, JAX shape, dims): the
    kernel transposed; the bias, quantized codes and scales and the LoRA
    factors (kept in the JAX layout by ``convert.py``) as they are."""
    if leaf == "weight":
        return "kernel", (shape[1], shape[0]), (1, 0)
    return leaf, tuple(shape), tuple(range(len(shape)))


def jax_leaf(name: str, shape) -> Optional[JaxLeaf]:
    """The JAX leaf of the port's parameter or buffer ``name`` (None for
    the port's own buffers, such as the CMVN)."""
    parts = name.split(".")
    shape = tuple(shape)
    ident = tuple(range(len(shape)))
    top, rest = parts[0], parts[1:]
    layer = None
    prefix: Tuple = (top,)
    if len(rest) > 1 and (top, rest[0]) in _STACKS:
        prefix, layer, rest = (top, rest[0]), int(rest[1]), rest[2:]
    elif top == "encoder" and rest and rest[0] == "encoders0":
        prefix, rest = (top, "encoders0"), rest[1:]
    elif top == "projector" and len(rest) > 1 and rest[0] == "layers":
        prefix, rest = (top, "layers", int(rest[1])), rest[2:]   # the q-former's list
    if top == "llm":
        if rest in (["embed_tokens", "weight"], ["norm", "weight"]):
            return JaxLeaf(prefix + (rest[0],), None, shape, ident)
        if rest == ["lm_head", "weight"]:
            return JaxLeaf(prefix + ("lm_head",), None, (shape[1], shape[0]), (1, 0))
        if layer is None:
            return None
        if len(rest) == 2 and rest[0] in _LLM_LINEARS:
            leaf, jshape, dims = _linear_leaf(rest[1], shape)
            return JaxLeaf(prefix + (rest[0], leaf), layer, jshape, dims)
        if rest[-1] == "weight":           # input_ / post_attention_layernorm
            return JaxLeaf(prefix + (rest[0],), layer, shape, ident)
        return JaxLeaf(prefix + (rest[0],), layer, shape, ident)   # adapter leaves
    if top == "encoder" and rest == ["query_embed"]:
        return JaxLeaf(prefix + ("query_embed",), None, shape, ident)
    if top == "projector" and rest == ["query"]:
        return JaxLeaf(prefix + ("query",), None, shape, ident)
    if top not in ("encoder", "projector") or len(rest) != 2:
        return None
    sub, leaf = rest
    if sub in ("fsmn", "conv") and leaf == "weight":
        # conv1d's [C_out, C_in, k] against the JAX [k, C_in, C_out]
        return JaxLeaf(prefix + (sub, "kernel"), layer, shape[::-1], (2, 1, 0))
    is_norm = sub.startswith(("norm", "ln_")) or sub in ("after_norm", "tp_norm", "out_norm")
    if is_norm:
        return JaxLeaf(prefix + (sub, leaf), layer, shape, ident)
    if top == "encoder" and sub not in _ENC_LINEARS:
        return None
    jleaf, jshape, dims = _linear_leaf(leaf, shape)
    return JaxLeaf(prefix + (sub, jleaf), layer, jshape, dims)


def _keys(path: Tuple) -> List[str]:
    """The JAX rule's keys of a path: a list index reads as ''."""
    return [k if isinstance(k, str) else "" for k in path]


def _named_shapes(model: nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    named += [(n, tuple(b.shape)) for n, b in model.named_buffers() if b is not None]
    return named


def param_shardings(
    named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], mesh_shape: Dict[str, int],
    min_size: int = 2 ** 16,
) -> Dict[Tuple, Spec]:
    """The JAX rule's spec of every JAX leaf of the port's tree
    (``(name, shape)`` pairs; stacked layers grouped back into one leaf),
    keyed by the leaf's JAX path."""
    leaves: Dict[Tuple, List] = {}
    for name, shape in named_shapes:
        leaf = jax_leaf(name, shape)
        if leaf is None:
            continue
        entry = leaves.setdefault(leaf.path, [leaf.shape, 0, leaf.layer is not None])
        entry[1] += leaf.layer is not None
    dims = {"pipe": 1, "data": 1, "fsdp": 1, "tensor": 1, **(mesh_shape or {})}
    out = {}
    for path, (shape, n_layers, stacked) in leaves.items():
        full = (n_layers,) + tuple(shape) if stacked else tuple(shape)
        out[path] = _param_spec(_keys(path), full, dims["fsdp"], min_size, dims["tensor"],
                                dims["pipe"])
    return out


def torch_placements(
    named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], mesh_shape: Dict[str, int],
    min_size: int = 2 ** 16,
) -> Dict[str, Spec]:
    """Each port tensor's placement in its own layout (one axis name or
    None a dimension), from :func:`param_shardings`; a stacked leaf's
    layer axis (``pipe``) is left out: the stage owns the whole layer."""
    named_shapes = list(named_shapes)
    specs = param_shardings(named_shapes, mesh_shape, min_size)
    out = {}
    for name, shape in named_shapes:
        leaf = jax_leaf(name, shape)
        if leaf is None:
            continue
        spec = specs[leaf.path][1:] if leaf.layer is not None else specs[leaf.path]
        mine: List[Optional[str]] = [None] * len(shape)
        for j, axis in enumerate(spec):
            mine[leaf.dims[j]] = axis
        out[name] = tuple(mine)
    return out


def pad_batch_to_multiple(batch: Dict[str, np.ndarray], mult: int):
    """Pad the leading batch dim to a multiple of the mesh batch size by
    repeating row 0 with a zeroed loss contribution (``batch_valid``)."""
    b = next(iter(batch.values())).shape[0]
    pad = (-b) % mult
    out = {}
    for k, v in batch.items():
        if pad:
            v = np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
        out[k] = v
    valid = np.ones((b + pad,), bool)
    if pad:
        valid[-pad:] = False
    out["batch_valid"] = valid
    return out


def shard_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """This process's batch (its ``GlobalBatcher`` block: with one process
    per device there is nothing to assemble) as tensors on ``device``."""
    from ps_slm_tpu_torch.training.loop import to_device_batch

    return to_device_batch(batch, device)


# ----------------------------------------------------------------------------
# applying the rules
# ----------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class Parallel:
    """This process's place on the mesh: its coordinates, the process
    groups of the axes wider than 1, the gradient sums the sharding needs
    and the layers its pipeline stage runs.  :func:`shard_params` sets it
    as ``model.mesh``."""

    def __init__(self, mesh, shape: Dict[str, int]):
        self.mesh = mesh
        self.shape = dict(shape)
        self.coords = dict(zip(AXES, mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a) for a in AXES if self.shape[a] > 1}
        self.fsdp_names: set = set()      # parameters FSDP2 shards (and sums over fsdp)
        # the tensor-parallel group (parallel/tensor.py), the tensors cut to
        # this rank's block over tensor (name -> (dim, by heads)) and the
        # whole ones whose gradients are partial (summed over tensor)
        self.shards = None
        self.tp: Dict[str, Tuple[int, bool]] = {}
        self.tensor_sum: set = set()
        self.per_stage = 0                # LLM layers a pipeline stage holds (pipe > 1)
        # the parameters and buffers of the other stages' layers, freed
        # here: name -> shape
        self.freed: Dict[str, torch.Size] = {}

    @property
    def row_block(self) -> Optional[RowBlock]:
        """This process's block of the global batch's rows (None: all)."""
        count = self.shape["data"] * self.shape["fsdp"]
        if count == 1:
            return None
        return RowBlock(self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"], count)

    @property
    def stage(self) -> int:
        return self.coords["pipe"]

    def stage_of(self, name: str) -> Optional[int]:
        """The pipeline stage that holds the LLM layer tensor ``name``
        (None: a tensor every stage holds)."""
        if not self.per_stage or not name.startswith("llm.layers."):
            return None
        return int(name.split(".")[2]) // self.per_stage

    def owner(self, name: str, t: torch.Tensor) -> int:
        """The rank that writes ``t`` (tensor ``name``, or a state kept for
        it) into a sharded train state: the one with this process's
        coordinates on the axes that shard ``t`` and 0 on those that
        replicate it, so each shard and each replicated tensor is written
        once.  A stage's layer tensors belong to that stage."""
        coords = {a: 0 for a in AXES}
        if name in self.tp:
            coords["tensor"] = self.coords["tensor"]
        if _is_dtensor(t):
            from torch.distributed.tensor import Replicate

            for axis, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
                if not isinstance(pl, Replicate):
                    coords[axis] = self.coords[axis]
        stage = self.stage_of(name)
        if stage is not None:
            coords["pipe"] = stage
        return int(self.mesh.mesh[tuple(coords[a] for a in AXES)])

    def held(self, model: nn.Module, names: List[str]) -> List[str]:
        """``names`` (trainable parameters) without the other stages'
        layers, whose parameters are frozen here (this process holds no
        copy of them to train)."""
        params = dict(model.named_parameters())
        for n in names:
            if n in self.freed:
                params[n].requires_grad_(False)
        return [n for n in names if n not in self.freed]

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch axes (data x fsdp), a new tensor."""
        t = t.clone()
        for axis in BATCH_AXES:
            if axis in self.groups:
                dist.all_reduce(t, group=self.groups[axis])
        return t

    def local_rows(self, draws):
        """Draws made at the global batch's shape (a NamedTuple of tensors
        or a list of per-layer dicts), cut to this process's rows."""
        block = self.row_block
        if draws is None or block is None:
            return draws

        def cut(t):
            if t is None:
                return None
            b = t.shape[0] // block.count
            return t[block.index * b:(block.index + 1) * b]

        if isinstance(draws, list):
            return [{k: cut(v) for k, v in d.items()} for d in draws]
        return type(draws)(*(cut(f) for f in draws))

    def sync_grads(self, model: nn.Module) -> None:
        """Sum the trainable parameters' gradients over the axes that split
        the batch: data and fsdp (FSDP2's reduce-scatter already summed
        over fsdp for the leaves it shards), and over tensor for the whole
        tensors a sharded module uses a block of (``tensor_sum``).  Never
        over pipe: a stage's layers get their gradients on that stage
        alone, the rest the same on every stage.  A parameter the loss does
        not reach gets a zero gradient first.  One all-reduce per set of
        axes and dtype, over the gradients flattened together."""
        buckets: Dict[Tuple, List[torch.Tensor]] = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            axes = ("data",) if name in self.fsdp_names else BATCH_AXES
            if name in self.tensor_sum:
                axes += ("tensor",)
            axes = tuple(a for a in axes if a in self.groups)
            if axes:
                g = p.grad.to_local() if _is_dtensor(p.grad) else p.grad
                buckets.setdefault((axes, g.dtype), []).append(g)
        for (axes, _), grads in buckets.items():
            flat = torch.cat([g.reshape(-1) for g in grads])
            for axis in axes:
                dist.all_reduce(flat, group=self.groups[axis])
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    @torch.no_grad()
    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Tensor ``name`` (a parameter, or a state kept for it) whole, in
        the one-process layout, on every process of its groups (a
        collective): FSDP2's shards gathered, then the tensor blocks (a
        by-heads ``qkv`` put back in q, k, v order)."""
        from ps_slm_tpu_torch.parallel.tensor import from_shards

        t = full_tensor(t) if _is_dtensor(t) else t.detach()
        if name not in self.tp:
            return t
        dim, by_heads = self.tp[name]
        return from_shards(self.shards.all_gather(t).unbind(0), dim, by_heads)

    def to_param_layout(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """A local tensor restored beside parameter ``p`` in ``p``'s layout
        (a DTensor of ``p``'s mesh and placements when ``p`` is one)."""
        if not _is_dtensor(p) or _is_dtensor(t):
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t.to(p.device), p.device_mesh, p.placements,
                                  shape=p.shape, stride=p.stride(), run_check=False)


def _shard(mod: nn.Module, key: str, dim: int, index: torch.Tensor) -> None:
    """Keep ``index`` of ``mod``'s parameter ``key`` on ``dim`` (the same
    Parameter, its data cut)."""
    p = getattr(mod, key)
    p.data = p.data.index_select(dim, index.to(p.device)).contiguous()


def _shard_linear(ctx: "Parallel", name: str, lin: nn.Module, kind: str,
                  rows: Optional[torch.Tensor] = None) -> None:
    """Cut ``lin`` (an ``nn.Linear`` named ``name``) to this rank's block:
    ``col`` its output rows (``rows``, default the contiguous block) with
    the bias, ``row`` its input columns (the bias stays whole, added after
    the sum).  ``in_features`` / ``out_features`` keep the whole widths."""
    shards = ctx.shards
    if kind == "col":
        if rows is None:
            rows = torch.arange(lin.out_features)[shards.block(lin.out_features)]
        _shard(lin, "weight", 0, rows)
        ctx.tp[f"{name}.weight"] = (0, name.endswith(".qkv"))
        if lin.bias is not None:
            _shard(lin, "bias", 0, rows)
            ctx.tp[f"{name}.bias"] = (0, name.endswith(".qkv"))
    else:
        _shard(lin, "weight", 1, torch.arange(lin.in_features)[shards.block(lin.in_features)])
        ctx.tp[f"{name}.weight"] = (1, False)


def _all_on(place: Dict[str, Spec], names: List[str], what: str) -> bool:
    """Whether the rule shards every one of ``names`` over tensor (the
    projections of one block shard together or not at all, so each rank
    keeps whole heads); raises when it shards some only."""
    on = [n for n in names if "tensor" in place.get(n, ())]
    if on and len(on) != len(names):
        raise ValueError(f"{what}: the rule shards {sorted(on)} over tensor but not the rest; "
                         "raise fsdp_min_size or use a tensor size that divides every "
                         "projection")
    return bool(on)


def shard_block(ctx: "Parallel", pre: str, layer: nn.Module, cfg) -> None:
    """Cut the Qwen2 block ``layer`` (named ``pre``) to this rank's heads:
    q/k/v/gate/up column-parallel, o/down row-parallel; its whole adapters
    get partial gradients (``tensor_sum``)."""
    from ps_slm_tpu_torch.models.lora import ADAPTER_LEAVES
    from ps_slm_tpu_torch.parallel.tensor import check_heads

    check_heads(pre, cfg.num_attention_heads, ctx.shards.size, cfg.num_key_value_heads)
    for n in _LLM_LINEARS:
        lin = getattr(layer, n)
        kind = "row" if n in _TP_ROW else "col"
        if kind == "row" and lin.bias is not None:
            raise ValueError(f"{pre}.{n}: a row-parallel projection with a bias")
        _shard_linear(ctx, f"{pre}.{n}", lin, kind)
    for name, _ in layer.named_parameters(prefix=pre):
        if name.rpartition(".")[2] in ADAPTER_LEAVES:
            ctx.tensor_sum.add(name)
    layer.tp = ctx.shards


def shard_sanm(ctx: "Parallel", pre: str, layer: nn.Module) -> None:
    """Cut the SANM layer ``layer`` (named ``pre``) to this rank's heads:
    ``qkv`` by heads and ``w1`` column-parallel, ``out`` and ``w2``
    row-parallel; its whole FSMN kernel gets partial gradients."""
    from ps_slm_tpu_torch.parallel.tensor import check_heads, qkv_rows

    check_heads(pre, layer.heads, ctx.shards.size)
    _shard_linear(ctx, f"{pre}.qkv", layer.qkv, "col",
                  qkv_rows(layer.size, ctx.shards.size, ctx.shards.rank))
    _shard_linear(ctx, f"{pre}.out", layer.out, "row")
    _shard_linear(ctx, f"{pre}.w1", layer.w1, "col")
    _shard_linear(ctx, f"{pre}.w2", layer.w2, "row")
    ctx.tensor_sum.add(f"{pre}.fsmn.weight")
    layer.tp = ctx.shards


@torch.no_grad()
def shard_tensor(model, ctx: "Parallel", place: Dict[str, Spec]) -> None:
    """Tensor parallelism over the mesh's ``tensor`` axis, by hand
    (``parallel/tensor.py``): every LLM block of this stage whose seven
    projections the rule shards (not an int8 / int4 one, whose leaves the
    rule replicates), every encoder layer whose ``qkv`` / ``out`` / ``w1``
    / ``w2`` it shards (``qkv`` by heads), linear-silu's and the q-former
    layers' ``ffn1`` / ``ffn2``, and the vocabulary rows of the table and
    an untied ``lm_head``; each module's ``tp`` set.  The whole adapters
    of a sharded block and the whole FSMN kernel of a sharded encoder
    layer get partial gradients: they are summed over tensor
    (``Parallel.tensor_sum``)."""
    from ps_slm_tpu_torch.parallel.tensor import Shards

    size = ctx.shape["tensor"]
    ctx.shards = shards = Shards(ctx.coords["tensor"], size, ctx.groups["tensor"])
    llm = model.llm
    for i, layer in enumerate(llm.layers):
        pre = f"llm.layers.{i}"
        if f"{pre}.input_layernorm.weight" not in ctx.freed and _all_on(
                place, [f"{pre}.{n}.weight" for n in _LLM_LINEARS], pre):
            shard_block(ctx, pre, layer, llm.cfg)
    enc = model.encoder
    layers = [("encoder.encoders0", enc.encoders0)]
    layers += [(f"encoder.encoders.{i}", m) for i, m in enumerate(enc.encoders)]
    layers += [(f"encoder.tp_encoders.{i}", m) for i, m in enumerate(enc.tp_encoders or ())]
    for pre, layer in layers:
        if _all_on(place, [f"{pre}.{n}.weight" for n in ("qkv", "out", "w1", "w2")], pre):
            shard_sanm(ctx, pre, layer)
    proj = model.projector
    mlps = [("projector", proj)] if hasattr(proj, "ffn1") else []
    mlps += [(f"projector.layers.{i}", m) for i, m in enumerate(getattr(proj, "layers", ()))
             if hasattr(m, "ffn1")]                    # the q-former's
    for pre, mod in mlps:
        if _all_on(place, [f"{pre}.ffn1.weight", f"{pre}.ffn2.weight"], pre):
            _shard_linear(ctx, f"{pre}.ffn1", mod.ffn1, "col")
            _shard_linear(ctx, f"{pre}.ffn2", mod.ffn2, "row")
            mod.tp = shards
    tables = ["llm.embed_tokens.weight"] + (["llm.lm_head.weight"] if llm.lm_head is not None
                                            else [])
    if _all_on(place, tables, "llm's vocabulary"):
        rows = torch.arange(llm.cfg.vocab_size)[shards.block(llm.cfg.vocab_size)]
        for name in tables:
            _shard(llm.embed_tokens if "embed_tokens" in name else llm.lm_head, "weight", 0, rows)
            ctx.tp[name] = (0, False)
        llm.vocab = shards


def _fsdp_units(model, ctx: "Parallel") -> List[nn.Module]:
    """The modules FSDP2 gathers one at a time: each transformer block of
    the encoder and of this stage's LLM layers, and the projector (the
    model itself last)."""
    enc = model.encoder
    units = [enc.encoders0, *enc.encoders]
    if getattr(enc, "tp_encoders", None) is not None:
        units += list(enc.tp_encoders)
    layers = [layer for i, layer in enumerate(model.llm.layers)
              if f"llm.layers.{i}.input_layernorm.weight" not in ctx.freed]
    return units + layers + [model.projector]


def shard_params(model, mesh, mesh_shape: Optional[dict] = None, min_size: int = 2 ** 16,
                 pp_microbatches: int = 0) -> Parallel:
    """Apply the placements to ``model`` (a ``TasuModel``, its freeze flags
    already set) in place and set ``model.mesh`` / ``model.pp_microbatches``:
    free the other pipeline stages' layers, shard over tensor
    (:func:`shard_tensor`), then FSDP2 over fsdp within the stage.  Build
    the optimizer afterwards: FSDP2 replaces the parameters."""
    shape = mesh_dims(mesh_shape, dist.get_world_size())
    ctx = Parallel(mesh, shape)
    if shape["pipe"] > 1 and model.llm.cfg.num_hidden_layers % shape["pipe"]:
        raise ValueError(f"pipeline: {model.llm.cfg.num_hidden_layers} layers not divisible "
                         f"by pipe={shape['pipe']}")
    place = torch_placements(_named_shapes(model), shape, min_size)
    if shape["pipe"] > 1:
        free_other_stages(model, ctx)
    if shape["tensor"] > 1:
        shard_tensor(model, ctx, place)
    if shape["fsdp"] > 1:
        from torch.distributed.fsdp import FSDPModule, fully_shard
        from torch.distributed.tensor import Shard

        dims, ignored = {}, set()
        for name, p in model.named_parameters():
            spec = place.get(name, ())
            if "fsdp" in spec and name not in ctx.freed:
                dims[id(p)] = spec.index("fsdp")
                ctx.fsdp_names.add(name)
            else:
                ignored.add(p)

        def placement(p):
            return Shard(dims[id(p)])

        for unit in _fsdp_units(model, ctx) + [model]:
            fully_shard(unit, mesh=mesh["fsdp"], shard_placement_fn=placement,
                        ignored_params=ignored)
        for m in model.modules():
            if isinstance(m, FSDPModule):
                # a plain sum (gloo takes no pre-scaled sum): nothing divides
                m.set_gradient_divide_factor(1.0)
                m.set_force_sum_reduction_for_comms(True)
    model.mesh = ctx
    model.pp_microbatches = pp_microbatches
    return ctx


def _layer_tensors(model):
    """(name, module, kind, key) of every parameter and buffer of the
    LLM's layers, in one order on every process."""
    for i, layer in enumerate(model.llm.layers):
        for mname, mod in layer.named_modules(prefix=f"llm.layers.{i}"):
            for kind in ("_parameters", "_buffers"):
                for key, t in getattr(mod, kind).items():
                    if t is not None:
                        yield f"{mname}.{key}", mod, kind, key


@torch.no_grad()
def free_other_stages(model, ctx: Parallel) -> None:
    """Keep this stage's L/P layers and free the rest (their tensors
    become empty, their shapes kept in ``ctx.freed``)."""
    ctx.per_stage = model.llm.cfg.num_hidden_layers // ctx.shape["pipe"]
    for name, mod, kind, key in _layer_tensors(model):
        if ctx.stage_of(name) != ctx.stage:
            t = getattr(mod, kind)[key]
            ctx.freed[name] = t.shape
            t.data = t.data.new_empty(0)


@torch.no_grad()
def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """An FSDP2 DTensor's whole tensor on every process of its (one-axis)
    mesh, gathered with a plain ``all_gather_into_tensor``, each shard
    padded to the largest: the DTensor's own ``full_tensor`` goes through
    functional collectives, which gloo does not take on CUDA tensors."""
    (pl,) = t.placements
    mesh, d, size = t.device_mesh, pl.dim, t.shape[pl.dim]
    k, n = 0, mesh.size(0)
    c = -(-size // n)                 # torch.chunk's sizes: c, ..., c, the rest, 0, ...
    x = t.detach().to_local().movedim(d, 0)
    if x.shape[0] < c:
        x = torch.cat([x, x.new_zeros((c - x.shape[0],) + tuple(x.shape[1:]))])
    buf = x.new_empty((n * c,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(buf, x.contiguous(), group=mesh.get_group(k))
    return buf[:size].movedim(0, d).contiguous()


@contextlib.contextmanager
def gathered(model: nn.Module, exclude: Iterable[str] = ()):
    """The whole parameters on every process for the duration, in the
    one-process layout: every FSDP2 and tensor-parallel shard replaced by
    its whole tensor (``Parallel.whole``) within each stage, then each
    pipeline stage's layers broadcast from that stage, and FSDP2's
    state-dict hooks (which put the shards back) held off, so
    ``state_dict()`` and the exporters read whole tensors.  The top-level
    submodules named in ``exclude`` ("llm", "encoder", "projector": those
    an export leaves out) keep their shards: nothing of them is gathered
    or broadcast.  A collective: every process enters it with the same
    ``exclude``.  The modules' forwards do not run on it."""
    ctx = getattr(model, "mesh", None)
    exclude = set(exclude)
    swapped, hooks = [], []
    for mname, mod in model.named_modules():
        if mod._state_dict_pre_hooks:
            hooks.append((mod, dict(mod._state_dict_pre_hooks)))
            mod._state_dict_pre_hooks.clear()
        if mname.split(".")[0] in exclude:
            continue
        for n, p in list(mod._parameters.items()):
            name = f"{mname}.{n}" if mname else n
            if p is not None and (_is_dtensor(p) or (ctx is not None and name in ctx.tp)):
                whole = ctx.whole(name, p) if ctx is not None else full_tensor(p)
                mod._parameters[n] = nn.Parameter(whole, requires_grad=False)
                swapped.append((mod, "_parameters", n, p))
    if ctx is not None and ctx.freed and "llm" not in exclude:
        group = ctx.groups["pipe"]
        with torch.no_grad():
            for name, mod, kind, key in _layer_tensors(model):
                t = getattr(mod, kind)[key]
                mine = name not in ctx.freed
                buf = t.contiguous() if mine else t.new_empty(ctx.freed[name])
                dist.broadcast(buf, dist.get_global_rank(group, ctx.stage_of(name)), group=group)
                if not mine:
                    getattr(mod, kind)[key] = (nn.Parameter(buf, requires_grad=False)
                                               if kind == "_parameters" else buf)
                    swapped.append((mod, kind, key, t))
    try:
        yield model
    finally:
        for mod, kind, n, p in reversed(swapped):
            getattr(mod, kind)[n] = p
        for mod, saved in hooks:
            mod._state_dict_pre_hooks.update(saved)
