"""Checkpoints as ``.npz`` files: the port's own format, and a reader for the
JAX package's that never imports JAX.

The port's format (:func:`save` / :func:`restore`): one array per leaf,
``a0``, ``a1``, ..., and ``__meta_json__``, the UTF-8 bytes of a JSON object
``{"format": FORMAT, "paths": [...], "bfloat16": [...], "extra": {...}}``
naming each leaf by its dotted path (a ``state_dict`` key).  numpy has no
bf16: a bf16 tensor is stored as its 16-bit patterns and listed under
``"bfloat16"``, and :func:`restore` gives it back as a bf16 torch tensor.
Nothing is pickled.

The JAX package's format (``repro.training.checkpoint.save``): the leaves
``a0``... in JAX's flatten order and ``__meta__``, a pickle of
``{"treedef": PyTreeDef, "extra": dict}``.  :func:`read_reference` unpickles
``__meta__`` with an unpickler that maps every ``jax`` / ``jaxlib`` global to
an inert stub and refuses every other global, so the file yields its
``extra`` and its leaves, never a JAX object; :func:`tree_from_leaves` puts
the leaves back into a tree whose structure the caller knows.
"""
from __future__ import annotations

import io
import json
import os
import pickle
from collections import OrderedDict
from typing import Any, List, Mapping, Tuple

import numpy as np

FORMAT = "repro_torch.checkpoint/1"


def _is_bf16(x) -> bool:
    return hasattr(x, "detach") and str(x.dtype) == "torch.bfloat16"


def _array(x) -> np.ndarray:
    if hasattr(x, "detach"):                # a torch tensor
        import torch

        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)         # the bit patterns
        x = x.numpy()
    return np.asarray(x)


def save(path: str, params: Mapping[str, Any], *, extra: dict = None) -> int:
    """Write ``params`` (dotted path -> tensor or array, a ``state_dict``)
    and ``extra`` (JSON values).  Returns the file's size in bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    paths = list(params)
    arrs = {f"a{i}": _array(params[p]) for i, p in enumerate(paths)}
    meta = json.dumps({"format": FORMAT, "paths": paths,
                       "bfloat16": [p for p in paths if _is_bf16(params[p])],
                       "extra": extra or {}})
    with open(path, "wb") as f:
        np.savez(f, __meta_json__=np.frombuffer(meta.encode(), np.uint8), **arrs)
    return os.path.getsize(path)


def _flatten(tree, path=""):
    """(leaves, paths) of a tree of dicts and lists: dict keys sorted (JAX's
    flatten order), list items in order."""
    if isinstance(tree, Mapping):
        pairs = [_flatten(tree[k], f"{path}{k}.") for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        pairs = [_flatten(x, f"{path}{i}.") for i, x in enumerate(tree)]
    else:
        return [tree], [path[:-1]]
    return ([x for leaves, _ in pairs for x in leaves],
            [p for _, paths in pairs for p in paths])


def _values(x) -> np.ndarray:
    """A leaf's values as numpy (a bf16 tensor widened to fp32: exact)."""
    if _is_bf16(x):
        x = x.float()
    return _array(x)


def tree_equal(a: Any, b: Any) -> bool:
    """Whether ``a`` and ``b`` have one structure and equal leaves, element by
    element, in sorted-key order (the reference's ``tree_equal``)."""
    la, pa = _flatten(a)
    lb, pb = _flatten(b)
    if pa != pb or len(la) != len(lb):
        return False
    return all(np.array_equal(_values(x), _values(y)) for x, y in zip(la, lb))


def is_reference(path: str) -> bool:
    """Whether ``path`` is in the JAX package's format (a pickled treedef)."""
    with np.load(path, allow_pickle=False) as z:
        return "__meta_json__" not in z.files and "__meta__" in z.files


def restore(path: str) -> Tuple["OrderedDict[str, np.ndarray]", dict]:
    """A checkpoint :func:`save` wrote -> (dotted path -> array, extra); a
    leaf saved from a bf16 tensor comes back as a bf16 torch tensor."""
    with np.load(path, allow_pickle=False) as z:
        if "__meta_json__" not in z.files:
            raise ValueError(f"{path}: not a {FORMAT} checkpoint (no __meta_json__); "
                             "a JAX-package checkpoint is read with read_reference")
        meta = json.loads(z["__meta_json__"].tobytes().decode())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: format {meta.get('format')!r} != {FORMAT!r}")
        state = OrderedDict((p, z[f"a{i}"]) for i, p in enumerate(meta["paths"]))
    if meta.get("bfloat16"):
        import torch

        for p in meta["bfloat16"]:
            state[p] = torch.from_numpy(state[p]).view(torch.bfloat16)
    return state, meta["extra"]


class _Inert:
    """What a ``jax`` / ``jaxlib`` global unpickles to: it takes any
    arguments and any state and keeps none of them."""

    def __init__(self, *_args, **_kwargs):
        pass

    def __setstate__(self, _state):
        pass


class _MetaUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in ("jax", "jaxlib"):
            return _Inert
        raise pickle.UnpicklingError(
            f"checkpoint metadata names the global {module}.{name}; only JAX's "
            "treedef types are accepted")


def read_reference(path: str) -> Tuple[List[np.ndarray], dict]:
    """A JAX-package checkpoint -> (leaves in JAX's flatten order, extra)."""
    with np.load(path, allow_pickle=False) as z:
        meta = _MetaUnpickler(io.BytesIO(z["__meta__"].tobytes())).load()
        n = len(z.files) - 1
        leaves = [z[f"a{i}"] for i in range(n)]
    if not isinstance(meta, dict) or not isinstance(meta.get("extra"), dict):
        raise ValueError(f"{path}: __meta__ holds no 'extra' dict")
    return leaves, meta["extra"]


def tree_from_leaves(like, leaves: List[np.ndarray]):
    """``leaves`` (JAX's flatten order) placed into the structure of ``like``
    (a tree of dicts and lists whose leaves carry ``.shape``); raises where
    the count or a shape disagrees."""
    it = iter(leaves)
    count = [0]

    def build(node, path):
        if isinstance(node, Mapping):
            return {k: build(node[k], f"{path}{k}.") for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(x, f"{path}{i}.") for i, x in enumerate(node)]
        try:
            leaf = next(it)
        except StopIteration:
            raise ValueError(f"checkpoint has {count[0]} leaves; the tree needs more "
                             f"(first missing: {path[:-1]})") from None
        count[0] += 1
        if tuple(leaf.shape) != tuple(node.shape):
            raise ValueError(f"leaf {count[0] - 1} ({path[:-1]}) has shape "
                             f"{tuple(leaf.shape)}, the tree expects {tuple(node.shape)}")
        return leaf

    out = build(like, "")
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"checkpoint has {count[0] + rest} leaves, the tree {count[0]}")
    return out
