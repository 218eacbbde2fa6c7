"""Logical-axis sharding rules (port of ``repro.sharding``): divisibility-aware
rules per (architecture, input shape, mesh), and the constraints models place
on their activations.

``make_rules`` is pure arithmetic on the mesh's axis sizes, so the dry run
and the partition specs (``launch/specs.py``) read it for the production
meshes with no devices at all.  A mesh is anything with named axis sizes: a
``launch.mesh.MeshShape``, a ``torch.distributed.device_mesh.DeviceMesh``
(its ``mesh_dim_names`` name its ``shape``), or an object whose ``shape`` is
a mapping from axis name to size.

:func:`logical` is where the reference places a GSPMD
``with_sharding_constraint``.  Under a rules context on a ``DeviceMesh`` it
redistributes a DTensor (``torch.distributed.tensor``) to the placements of
its spec (:func:`placements`): a split dim becomes ``Shard``, a ``None``
entry ``Replicate``, and a ``Partial`` sum is reduced there, where GSPMD
would place its collective.  The models are then DTensor programs: the
parameters and the batch are placed by ``launch/specs.py``, the ops between
two constraints propagate their shardings, and the hand kernels run on each
rank's local shard (``kernels/ops.py``).  Outside a rules context, under a
``MeshShape`` (the dry run) and on meta tensors :func:`logical` returns its
input; a plain tensor that a constraint would split over several ranks is
refused, so nothing runs unsharded in silence.  The expert-parallel MoE
(``models/moe.py``) reads the rules and the mesh through
:func:`current_rules_and_mesh` and places its own collectives.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

_state = threading.local()


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, Axis], mesh):
    prev = _current()
    _state.ctx = (dict(rules), mesh)
    try:
        yield
    finally:
        _state.ctx = prev


def current_rules_and_mesh():
    """(rules, mesh) if a rules context is active, else None — used by the
    explicit collective paths (expert-parallel MoE)."""
    return _current()


def axis_sizes(mesh) -> Mapping[str, int]:
    """The mesh's axis sizes by name."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                     # a DeviceMesh: shape is a tuple
        return dict(zip(names, mesh.shape))
    return mesh.shape


def spec_for(names: Sequence[Optional[str]]) -> Spec:
    """The mesh axes of a tensor whose dims carry ``names`` under the active
    rules; ``()`` (replicated) outside a rules context."""
    ctx = _current()
    if ctx is None:
        return ()
    rules, _ = ctx
    return tuple(rules.get(n) if n else None for n in names)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (``torch.distributed.tensor.DTensor``)."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                       # a build without distributed
        return False
    return isinstance(x, DTensor)


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where tensor dim ``d`` is split over that mesh axis, else
    ``Replicate()``; an axis of size 1 splits nothing and replicates (DTensor
    would refuse to fold a dim "split" over one rank into another).  A tuple
    entry such as ``("pod", "data")`` splits one tensor dim over both mesh
    axes, the first named outermost, as GSPMD does; DTensor splits in mesh
    order, so the tuple must follow it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate()] * len(names)
    used = set()
    for dim, ax in enumerate(spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        where = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in mesh {names}")
            if a in used:
                raise ValueError(f"spec {spec} splits two dims over mesh axis {a!r}")
            used.add(a)
            i = names.index(a)
            where.append(i)
            if sizes[a] > 1:
                out[i] = Shard(dim)
        if where != sorted(where):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {dim} are not in "
                             f"the mesh's order {names}")
    return out


def logical(x, names: Sequence[Optional[str]]):
    """Constrain tensor ``x`` whose dims carry logical names (None = any):
    the reference's ``with_sharding_constraint``.

    A DTensor under a rules context on a ``DeviceMesh`` is redistributed to
    the spec's placements (any ``Partial`` is reduced here).  ``x`` itself
    comes back outside a rules context, on a meta tensor, and where the
    constraint splits nothing; a plain tensor the constraint would split over
    several ranks raises."""
    ctx = _current()
    if ctx is None or x.device.type == "meta":
        return x
    _, mesh = ctx
    spec = spec_for(names)
    if _is_device_mesh(mesh) and is_dtensor(x):
        want = placements(spec, mesh)
        if list(x.placements) == want:
            return x
        return x.redistribute(mesh, want)
    if all(_axsize(mesh, ax) == 1 for ax in spec):
        return x
    if _is_device_mesh(mesh):
        raise ValueError(
            f"a sharding constraint {spec} over mesh {dict(axis_sizes(mesh))} splits a "
            f"plain tensor of shape {tuple(x.shape)}: place the parameters and the batch "
            f"as DTensors (launch.specs.distribute_params / distribute_batch) first")
    raise NotImplementedError(
        f"a sharding constraint {spec} over mesh {dict(axis_sizes(mesh))} splits a "
        f"tensor across ranks, and a {type(mesh).__name__} has no devices to hold the "
        f"shards: run it over a DeviceMesh (launch.mesh), the GSPMD path of ROADMAP "
        f"item A8")


def shard_offset(mesh, plc, dim: int, size: int) -> int:
    """This rank's first index along tensor dim ``dim`` (of ``size``) under
    DTensor placements ``plc``, which split it evenly, the first mesh dim
    outermost (DTensor's order)."""
    off, n = 0, size
    for i, p in enumerate(plc):
        if p.is_shard(dim):
            n //= mesh.size(i)
            off += mesh.get_local_rank(i) * n
    return off


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor ``x`` it runs on the
    local shard (``local_map``), for the ops DTensor has no sharding
    strategy for (``log_sigmoid``'s backward), its split kept."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    plc = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=plc, in_placements=(plc,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def like(t, ref):
    """``t`` in DTensor ``ref``'s placements where both are DTensors (a
    decode state leaves a step in its cache's layout, ``specs.cache_pspec``);
    else ``t``."""
    if not (is_dtensor(t) and is_dtensor(ref)) or list(t.placements) == list(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def replicate_like(t, ref):
    """``t``, a tensor every rank computes alike (positions, masks, rope
    tables, zeros), as a replicated DTensor on ``ref``'s mesh where ``ref``
    is a DTensor, so that ops mixing the two see one kind; else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


# --------------------------------------------------------------------------- #
# rule construction per (arch config, input shape, mesh)
# --------------------------------------------------------------------------- #


def _axsize(mesh, ax: Axis) -> int:
    if ax is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(ax, str):
        return sizes[ax]
    n = 1
    for a in ax:
        n *= sizes[a]
    return n


def make_rules(cfg, shape, mesh, *, seq_shard: Optional[bool] = None) -> Dict[str, Axis]:
    """Build logical->mesh rules for one (arch, shape, mesh) combination.

    Logical axes used across the codebase:
      batch       activation batch / MoE group dim
      seq         sequence dim of activations & KV caches
      embed       d_model dim of activations (sharded only as fallback TP)
      heads/kv_heads  attention head dims (params & activations & caches)
      ff          FFN hidden dim
      qkv         fused q/k/v output dim of attention params
      vocab       embedding/unembedding vocab dim
      expert      MoE expert dim
      layers      stacked-layer leading dim (never sharded)
      fsdp        weight-shard dim for non-TP dims of params
    """
    sizes = axis_sizes(mesh)
    data_axes: Axis = tuple(a for a in ("pod", "data") if a in sizes) or None
    model: Axis = "model" if "model" in sizes else None
    msize = _axsize(mesh, model)

    def fits(dim: int, ax: Axis) -> Axis:
        return ax if (ax is not None and dim % _axsize(mesh, ax) == 0 and dim >= _axsize(mesh, ax)) else None

    rules: Dict[str, Axis] = {}
    rules["layers"] = None
    # batch: decode long_500k has batch 1 -> unshardable; shard seq instead.
    rules["batch"] = fits(shape.global_batch, data_axes)
    shard_seq = seq_shard if seq_shard is not None else (rules["batch"] is None)
    rules["seq"] = fits(shape.seq_len, data_axes) if shard_seq else None
    # tensor-parallel dims
    rules["heads"] = fits(cfg.num_heads, model)
    rules["kv_heads"] = fits(cfg.num_kv_heads, model)
    rules["ff"] = fits(max(cfg.d_ff, cfg.moe.expert_ff if cfg.moe else 0), model)
    rules["qkv"] = fits(cfg.q_dim, model) if rules["heads"] is not None else None
    # vocab: padded shardings are allowed for the vocab dim (it appears only
    # in matmul outputs and gathers), so it need not divide the axis
    rules["vocab"] = model if (model and cfg.vocab_size >= msize) else None
    # ... but the embed/unembed parameters themselves need even shards:
    rules["vocab_param"] = fits(cfg.vocab_size, model)
    rules["expert"] = fits(cfg.moe.num_experts, model) if cfg.moe else None
    # embed: activations' d_model dim stays whole; params' d_model dim is the
    # fsdp dim
    rules["embed"] = None
    rules["fsdp"] = fits(cfg.d_model, data_axes) if data_axes else None
    # decode keeps weights tensor-parallel and stationary: replicated over the
    # data axes when the model-sharded params fit (<= 8 GiB a chip).  MoE
    # archs are excluded (every local expert's weights are read each step).
    # `full_param_count` keeps the guard consistent under scaled layer counts.
    if shape.kind == "decode" and msize and cfg.moe is None:
        itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
        n_params = getattr(cfg, "full_param_count", 0) or cfg.param_count()
        per_chip_gb = n_params * itemsize / msize / 2**30
        if per_chip_gb <= 8.0:
            rules["fsdp"] = None
    # inner SSM dims
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        rules["ssm_inner"] = fits(d_in, model)
    if cfg.xlstm is not None:
        d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
        rules["xlstm_inner"] = fits(d_in, model)
    rules["moe_group"] = rules["batch"]
    # context-parallel attention fallback for training: when heads do not
    # divide the model axis (qwen2.5's 40, whisper's 20, internvl2's 14),
    # attention's tokens shard over `model` on the sequence dim instead
    rules["attn_seq"] = (fits(shape.seq_len, model)
                         if (rules["heads"] is None and shape.kind == "train")
                         else None)
    # sequence-parallel residual stream for training, pure-attention archs
    # only: EP-MoE assumes model-replicated tokens, and recurrent time scans
    # cannot consume a seq-sharded input
    if (shape.kind == "train" and model is not None
            and cfg.moe is None and cfg.ssm is None and cfg.xlstm is None
            and shape.seq_len % msize == 0):
        rules["seq"] = model
    # decode KV caches: batch over data; the (long) sequence dim over model
    if shape.kind == "decode":
        rules["cache_batch"] = fits(shape.global_batch, data_axes)
        rules["cache_seq"] = fits(shape.seq_len, model)
    return rules
