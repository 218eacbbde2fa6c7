"""Carry a JAX parameter tree across to the port's ``state_dict``, and back.

The JAX package stacks each period position's leaves over the ``n_rep``
repeats on axis 0 (``repro.models.transformer.init_stack``); the port keeps
one ``Block`` per layer, so layer ``rep * period + pos`` takes slice ``rep``
of position ``pos``.  The encoder-decoder's ``enc_blocks`` / ``dec_blocks``
are one dict each, stacked over all its layers (``jax.vmap`` of the layer
init): layer ``i`` takes slice ``i``.  Dense weights stay ``(in, out)`` on both sides (the
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


# the keys under which a tree stacks its layers over a period's repeats:
# the LM's ``blocks`` (``lm.init_lm``) and the gap forecaster's ``stack``
# (``learn.forecaster.init_forecaster``)
STACKED = ("blocks", "stack")
# the keys under which a tree stacks every layer of a stack in one dict
# (``encdec.init_encdec``)
LAYER_STACKED = ("enc_blocks", "dec_blocks")


def params_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """A JAX parameter tree (numpy leaves) -> the port's ``state_dict``.

    Trees: ``lm.init_lm`` (the port's ``LM``), ``encdec.init_encdec`` (the
    port's ``EncDec``), the gap forecaster
    (``inp``, ``stack``, ``norm``, ``head``: the port's ``Forecaster``), the
    DQN's Q-net (``l1``, ``l2``, ``out``) and the LSTM predictor's
    (``wx``, ``wh``, ``b``, ``wo``, ``bo``).  A stacked key (:data:`STACKED`,
    :data:`LAYER_STACKED`) becomes one entry per layer; every other leaf
    keeps its dotted path."""
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in tree.items() if k not in STACKED + LAYER_STACKED},
             "", flat)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict(
        (k, _tensor(v)) for k, v in flat.items())
    for key in (k for k in LAYER_STACKED if k in tree):
        leaves = {}
        _flatten(tree[key], "", leaves)
        for name, a in leaves.items():
            for layer in range(a.shape[0]):
                out[f"{key}.{layer}.{name}"] = _tensor(a[layer])
    for key in (k for k in STACKED if k in tree):
        period = len(tree[key])
        for pos, stacked in enumerate(tree[key]):
            leaves: Dict[str, Any] = {}
            _flatten(stacked, "", leaves)
            n_rep = {a.shape[0] for a in leaves.values()}
            if len(n_rep) != 1:
                raise ValueError(f"{key}[{pos}] leaves disagree on the repeat axis: {n_rep}")
            for rep in range(n_rep.pop()):
                layer = rep * period + pos
                for name, a in leaves.items():
                    out[f"{key}.{layer}.{name}"] = _tensor(a[rep])
    return out


def nest(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Dotted paths -> nested dicts (e.g. the DQN's ``{"l1": {"w", "b"}, ...}``
    from :func:`params_from_jax`'s ``l1.w``, ``l1.b``, ...)."""
    tree: Dict[str, Any] = {}
    for name, a in state.items():
        node = tree
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = a
    return tree


def params_to_jax(state: Mapping[str, Any], period: int) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> the JAX
    tree's layout (nested dicts; a stacked key's layers stacked over the
    repeats of a ``period``-layer period, one entry a period position; a
    layer-stacked key's over all its layers, one dict).  Leaves stay tensors
    (meta tensors too: the layout alone is wanted)."""
    stacked = STACKED + LAYER_STACKED
    tree = nest({k: v for k, v in state.items() if k.partition(".")[0] not in stacked})
    layers: Dict[str, Dict[int, Dict[str, Any]]] = {}
    for name, a in state.items():
        head, _, rest = name.partition(".")
        if head in stacked:
            idx, _, leaf = rest.partition(".")
            layers.setdefault(head, {}).setdefault(int(idx), {})[leaf] = a
    for key, by_layer in layers.items():
        n = len(by_layer)
        if key in LAYER_STACKED:
            tree[key] = nest({leaf: torch.stack([by_layer[i][leaf] for i in range(n)])
                              for leaf in by_layer[0]})
            continue
        if n % period:
            raise ValueError(f"{key}: {n} layers are not whole periods of {period}")
        reps = n // period
        tree[key] = [
            nest({leaf: torch.stack([by_layer[r * period + pos][leaf] for r in range(reps)])
                  for leaf in by_layer[pos]})
            for pos in range(period)]
    return tree
