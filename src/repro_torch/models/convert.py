"""Carry a JAX parameter tree across to the port's ``state_dict``.

The JAX package stacks each period position's leaves over the ``n_rep``
repeats on axis 0 (``repro.models.transformer.init_stack``); the port keeps
one ``Block`` per layer, so layer ``rep * period + pos`` takes slice ``rep``
of position ``pos``.  Dense weights stay ``(in, out)`` on both sides (the
port computes ``x @ w``), so nothing is transposed.  The tree arrives as
nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``):
this module never sees a JAX type.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                         # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            _flatten(val, name + ".", out)
        else:
            out[name] = val


def params_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``lm.init_lm`` tree (numpy leaves) -> the port's ``LM`` state_dict."""
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in tree.items() if k != "blocks"}, "", flat)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict(
        (k, _tensor(v)) for k, v in flat.items())
    period = len(tree["blocks"])
    for pos, stacked in enumerate(tree["blocks"]):
        leaves: Dict[str, Any] = {}
        _flatten(stacked, "", leaves)
        n_rep = {a.shape[0] for a in leaves.values()}
        if len(n_rep) != 1:
            raise ValueError(f"blocks[{pos}] leaves disagree on the repeat axis: {n_rep}")
        for rep in range(n_rep.pop()):
            layer = rep * period + pos
            for name, a in leaves.items():
                out[f"blocks.{layer}.{name}"] = _tensor(a[rep])
    return out
