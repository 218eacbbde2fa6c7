"""Partition specs for parameters, optimizer state, batches and decode caches
(port of ``repro.launch.specs``), from the divisibility-checked logical rules
of ``repro_torch.sharding.make_rules``.

A spec is a tuple of mesh-axis names (or ``None``, or a tuple of names), one
entry a dimension: the reference's ``PartitionSpec``.  The leaves are named
the port's way: a parameter by its ``state_dict`` name (one entry a layer,
``blocks.<layer>.attn.wq``, with no stacked lead axis), a cache leaf by its
dotted path in the port's caches (``<layer>.k`` for a decoder-only model,
``self.<layer>.k`` / ``cross.<layer>.k`` for the encoder-decoder).

Layout summary:
  params     TP dims (q_dim when heads divide, d_ff, experts, vocab-when-
             divisible, SSM/xLSTM inner dims) over ``model``; the d_model dim
             over ``data`` (+``pod``) as the FSDP shard.
  batch      (B, S) over (pod, data) on B.
  caches     B over data axes, long KV sequence dim over ``model``.

:func:`local_shape` gives a leaf's per-device shape under a spec, padded as
GSPMD pads an uneven split (granite's vocab of 49155 over 16 ranks).

:func:`distribute_params`, :func:`distribute_opt_state`,
:func:`distribute_batch`, :func:`distribute_caches` and
:func:`distribute_token` apply the specs on a ``DeviceMesh``, the port's
``jax.device_put(tree, shardings)``: each leaf becomes a DTensor with the
placements of its spec (``sharding.placements``), its shards taken from
rank 0's copy (a cache leaf that is a DTensor already is redistributed).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

from repro_torch.sharding import Spec, _axsize, axis_sizes, is_dtensor, placements


def _names(rules, names) -> Spec:
    return tuple(rules.get(n) if n else None for n in names)


def param_pspec(name: str, ndim: int, rules: Dict[str, Any]) -> Spec:
    """Spec of one parameter leaf addressed by its ``state_dict`` name."""
    path = name.replace(".", "/")

    def mk(*names):
        spec = _names(rules, names)
        if len(spec) != ndim:
            raise ValueError(f"{name}: a spec of {len(spec)} dims for a {ndim}-dim leaf")
        return spec

    last = path.rsplit("/", 1)[-1]
    # top-level tables
    if path == "embed":
        return mk("vocab_param", "fsdp")
    if path == "unembed":
        return mk("fsdp", "vocab_param")
    if path == "pos":
        return mk(None, "fsdp")
    if path == "proj":
        return mk(None, None)
    if "norm" in path or last in ("scale", "bias"):
        return (None,) * ndim

    if "/moe/" in path and "/dense/" not in path:
        if last == "router":
            return mk("fsdp", None)
        if last in ("wi", "wg"):
            return mk("expert", "fsdp", None)
        if last == "wo":
            return mk("expert", None, "fsdp")
    if "/ffn/" in path or "/dense/" in path:
        if last in ("wi", "wg"):
            return mk("fsdp", "ff")
        if last == "wo":
            return mk("ff", "fsdp")
    if "/attn/" in path or "/self/" in path or "/cross/" in path:
        if last == "wq":
            return mk("fsdp", "qkv")
        if last in ("wk", "wv"):
            return mk("fsdp", None)
        if last == "wo":
            return mk("qkv", "fsdp")
        if last == "bq":
            return mk("qkv")
        if last in ("bk", "bv"):
            return mk(None)
    if "/ssm/" in path:
        table = {
            "in_proj": ("fsdp", "ssm_inner"),
            "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",),
            "x_proj": ("ssm_inner", None),
            "dt_w": (None, "ssm_inner"),
            "dt_b": ("ssm_inner",),
            "A_log": ("ssm_inner", None),
            "D": ("ssm_inner",),
            "out_proj": ("ssm_inner", "fsdp"),
        }
        if last in table:
            return mk(*table[last])
    if "/xl/" in path:
        table = {
            "up": ("fsdp", "xlstm_inner"),
            "wq": (None, "xlstm_inner"),
            "wk": (None, "xlstm_inner"),
            "wv": (None, "xlstm_inner"),
            "down": ("xlstm_inner", "fsdp"),
            "skip": ("xlstm_inner",),
            "wx": (None, "xlstm_inner"),
            "wh": (None, None, None),
            "b": ("xlstm_inner",),
            "w_i": (None, None), "w_f": (None, None),
            "b_i": (None,), "b_o": (None,), "b_f": (None,),
            "wo": ("xlstm_inner",), "bo": (None,),
        }
        if last in table:
            return mk(*table[last])
    # default: replicated
    return (None,) * ndim


def _check_axes(spec: Spec, mesh) -> Spec:
    """``spec`` itself, after checking that the mesh has every axis it names."""
    sizes = axis_sizes(mesh)
    for ax in spec:
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            if a not in sizes:
                raise ValueError(f"spec {spec} names axis {a!r}, not in mesh {dict(sizes)}")
    return spec


def params_shardings(params_spec: Mapping[str, Any], rules, mesh) -> Dict[str, Spec]:
    """``{name: spec}`` for a ``state_dict`` (tensors or meta tensors)."""
    return {name: _check_axes(param_pspec(name, x.dim(), rules), mesh)
            for name, x in params_spec.items()}


def opt_state_shardings(opt_spec, params_shardings_tree, mesh):
    """m/v mirror the params; step is replicated."""
    from repro_torch.training.optimizer import OptState
    del opt_spec, mesh  # the reference's signature: the state mirrors the params
    return OptState((), params_shardings_tree, params_shardings_tree)


def batch_shardings(batch_spec: Mapping[str, Any], rules, mesh) -> Dict[str, Spec]:
    b = rules.get("batch")
    return {k: _check_axes((b,) + (None,) * (x.dim() - 1), mesh)
            for k, x in batch_spec.items()}


def cache_pspec(path: str, ndim: int, rules: Dict[str, Any]) -> Spec:
    """Spec of one cache leaf of the port's layout (one entry a layer)."""
    cb = rules.get("cache_batch")
    cs = rules.get("cache_seq")
    last = path.rsplit(".", 1)[-1]
    if last in ("k", "v"):         # (B, S, Hkv, hd)
        if "cross" in path:
            cs = None              # encoder frames (1500) — not the seq_len dim
        return (cb, cs, None, None)
    if last == "conv":             # (B, d_conv-1, d_in)
        return (cb,) + (None,) * (ndim - 1)
    if last == "h" and ndim >= 3:  # mamba h (B, d_in, N)
        return (cb, rules.get("ssm_inner"), None)
    # xLSTM states and anything else: batch on dim 0
    if ndim >= 1:
        return (cb,) + (None,) * (ndim - 1)
    return ()


def _tree_map_with_path(fn, tree, path=""):
    if isinstance(tree, Mapping):
        return {k: _tree_map_with_path(fn, v, f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_with_path(fn, v, f"{path}{i}.") for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def caches_shardings(caches_spec, rules, mesh):
    """The caches' structure with each leaf's spec in its place."""
    return _tree_map_with_path(
        lambda path, x: _check_axes(cache_pspec(path, x.dim(), rules), mesh), caches_spec)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """Per-device sizes of a ``shape`` split by ``spec`` over ``mesh``: each
    dim divided by its axes' size, rounded up (GSPMD pads an uneven split)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(math.ceil(n / _axsize(mesh, ax)) for n, ax in zip(shape, spec))


def _distribute(x, spec: Spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x.detach(), mesh, placements(spec, mesh))


def distribute_params(model, rules, mesh):
    """Every parameter of ``model`` (an ``nn.Module``) becomes, in place, an
    ``nn.Parameter`` holding a DTensor placed by :func:`param_pspec` on the
    ``DeviceMesh`` ``mesh``.  Returns ``model``."""
    import torch

    shardings = params_shardings(dict(model.named_parameters()), rules, mesh)
    for name, spec in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        old = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(_distribute(old, spec, mesh),
                                              requires_grad=old.requires_grad))
    return model


def distribute_opt_state(state, params_shardings_tree, mesh):
    """The AdamW state on ``mesh``: m / v by their parameters' specs
    (:func:`opt_state_shardings`), the step count replicated as it is."""
    sh = opt_state_shardings(state, params_shardings_tree, mesh)
    return type(state)(state.step,
                       {k: _distribute(x, sh.m[k], mesh) for k, x in state.m.items()},
                       {k: _distribute(x, sh.v[k], mesh) for k, x in state.v.items()})


def distribute_batch(batch: Mapping[str, Any], rules, mesh) -> Dict[str, Any]:
    """A batch of tensors on ``mesh``, each split on its batch dim by
    :func:`batch_shardings`."""
    sh = batch_shardings(batch, rules, mesh)
    return {k: _distribute(x, sh[k], mesh) for k, x in batch.items()}


def distribute_caches(caches, rules, mesh):
    """The decode caches on ``mesh``, each leaf placed by :func:`cache_pspec`
    (the reference's ``caches_shardings`` as ``in_shardings``): a plain leaf
    is distributed, a DTensor leaf (a sharded prefill's) redistributed."""
    def place(path, x):
        spec = _check_axes(cache_pspec(path, x.dim(), rules), mesh)
        if not is_dtensor(x):
            return _distribute(x, spec, mesh)
        want = placements(spec, mesh)
        return x if list(x.placements) == want else x.redistribute(mesh, want)

    return _tree_map_with_path(place, caches)


def distribute_token(token, rules, mesh):
    """Decode's (B,) token on ``mesh``, split as the caches' batch
    (``P(cache_batch)``, the reference's dry run)."""
    return _distribute(token, _check_axes((rules.get("cache_batch"),), mesh), mesh)
