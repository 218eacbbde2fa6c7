"""Logical-axis sharding rules (port of ``repro.sharding``): divisibility-aware
rules per (architecture, input shape, mesh), and the constraints models would
place on their activations.

``make_rules`` is pure arithmetic on the mesh's axis sizes, so the dry run
and the partition specs (``launch/specs.py``) read it for the production
meshes with no devices at all.  A mesh is anything with named axis sizes: a
``launch.mesh.MeshShape``, a ``torch.distributed.device_mesh.DeviceMesh``
(its ``mesh_dim_names`` name its ``shape``), or an object whose ``shape`` is
a mapping from axis name to size.

:func:`logical` is where the reference places a GSPMD
``with_sharding_constraint``.  Here it returns its input unchanged outside a
rules context and wherever every mesh axis it maps to has size 1 (one H100,
or a ``(1, 1)`` mesh).  A constraint that would really split a tensor over
several ranks has no counterpart yet: GSPMD execution over a multi-card mesh
(``logical`` constraints becoming DTensor placements) is ROADMAP item A8, and
until it lands such a call raises rather than run unsharded silently.  The
one path that does run across ranks is the expert-parallel MoE
(``models/moe.py``), which reads the rules and the mesh through
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


def logical(x, names: Sequence[Optional[str]]):
    """Constrain tensor ``x`` whose dims carry logical names (None = any).

    Returns ``x`` where the constraint splits nothing (no rules context, or
    only size-1 mesh axes); raises where it would split ``x`` over ranks."""
    ctx = _current()
    if ctx is None:
        return x
    _, mesh = ctx
    spec = spec_for(names)
    if all(_axsize(mesh, ax) == 1 for ax in spec):
        return x
    raise NotImplementedError(
        f"a sharding constraint {spec} over mesh {dict(axis_sizes(mesh))} splits a "
        f"tensor across ranks; GSPMD execution over a multi-card mesh is ROADMAP "
        f"item A8 (logical constraints as DTensor placements)")


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
