"""The port's routed-MoE FFN against the JAX package's, on the same weights.

The JAX ``init_moe`` tree is carried across as numpy arrays under its own
names (``router``, ``wi``, ``wg``, ``wo``, ``dense.*``).  Output and aux loss
are compared at 1e-5 abs/rel in fp32: both sides route the same tokens to
the same experts (the routing is exact integer work once the router's
probabilities agree to ~1e-7) and differ only in the summation order of the
expert products.  Cases: jamba's SMOKE layer, qwen3-moe's, arctic's (with its
dense residual), a capacity factor that drops tokens, and several dispatch
groups (``GROUP`` lowered in both packages).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    # name: (arch, config fields, MoE fields), applied to both packages' SMOKE
    "jamba": ("jamba_v01_52b", {}, {}),
    "qwen3_moe": ("qwen3_moe_30b_a3b", {}, {}),
    "arctic_dense_residual": ("arctic_480b", {}, {}),
    "capacity_drops": ("jamba_v01_52b", {}, {"capacity_factor": 0.5}),
    "gelu_experts": ("jamba_v01_52b", {"act": "gelu"}, {}),
}


def _cfg(package, arch, cfg_kw, moe_kw):
    cfg = importlib.import_module(f"{package}.configs.{arch}").SMOKE
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw), **cfg_kw)


def _layer(arch, cfg_kw, moe_kw, seed=0):
    """(JAX config, JAX params, the port's MoE on the same weights, port config)."""
    jcfg = _cfg("repro", arch, cfg_kw, moe_kw)
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    tcfg = _cfg("repro_torch", arch, cfg_kw, moe_kw)
    layer = tmoe.MoE(tcfg, device="meta")
    flat = {}
    for k, v in jp.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
                          assign=True)
    return jcfg, jp, layer, tcfg


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", [(2, 12), (1, 1)], ids=["prefill", "decode"])
def test_moe_ffn_matches_jax(name, shape):
    jcfg, jp, layer, tcfg = _layer(*CASES[name])
    x = np.random.default_rng(1).normal(size=(*shape, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_ffn(layer, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_capacity_drops_some_assignments():
    """The dropping case really drops: 4 experts of capacity 6 for the 48
    assignments of 24 tokens."""
    jcfg, _, _, tcfg = _layer(*CASES["capacity_drops"])
    assert tmoe._capacity(24, tcfg.moe) == jmoe._capacity(24, jcfg.moe) == 6
    assert tmoe._capacity(24, tcfg.moe) * tcfg.moe.num_experts < 24 * tcfg.moe.top_k


@pytest.mark.parametrize("t", [1, 2, 5, 24, 4096])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_capacity_matches_jax(t, cf):
    for arch in ("jamba_v01_52b", "qwen3_moe_30b_a3b", "arctic_480b"):
        jm, tm = (dataclasses.replace(importlib.import_module(f"{pkg}.configs.{arch}")
                                      .CONFIG.moe, capacity_factor=cf)
                  for pkg in ("repro", "repro_torch"))
        assert tmoe._capacity(t, tm) == jmoe._capacity(t, jm)


@pytest.mark.parametrize("tokens", [(2, 24), (1, 50)], ids=["three_groups", "ragged_one_group"])
def test_dispatch_groups_match_jax(monkeypatch, tokens):
    """GROUP lowered to 16 in both packages: 48 tokens make three groups of 16
    (aux is their mean); 50 tokens do not divide and run as one group."""
    monkeypatch.setattr(jmoe, "GROUP", 16)
    monkeypatch.setattr(tmoe, "GROUP", 16)
    jcfg, jp, layer, tcfg = _layer(*CASES["capacity_drops"])
    x = np.random.default_rng(2).normal(size=(*tokens, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_ffn(layer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_router_ties_take_the_lower_expert_first():
    """lax.top_k orders equal probabilities by index; so does the port.  A
    zero router gives every expert the same probability."""
    jcfg, jp, layer, tcfg = _layer(*CASES["jamba"])
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    with torch.no_grad():
        layer.router.zero_()
    x = np.random.default_rng(3).normal(size=(1, 6, jcfg.d_model)).astype(np.float32)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, _ = tmoe.moe_ffn(layer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
