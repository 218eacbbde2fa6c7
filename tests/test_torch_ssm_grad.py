"""The gradient of the port's selective scan against the JAX package's.

The JAX package trains its hybrid models through ``jax.vjp`` of its jnp
two-level scan (``repro.kernels.ops.ssm_scan``, ``impl="reference"``); the
Pallas scan has no VJP.  The same numpy inputs go through that and through
the port's plain backward (``ssm_scan_bwd_plain``, the backward kernel's
arithmetic, which the CPU runs), with nonzero h0 and dhT.  Tolerances:
fp32 1e-4 (sums over channels, time and states in another order, ``exp``
against XLA's); bf16 u, B and C 5e-2, as the forward's tests hold bf16 (du,
dB and dC come back rounded to bf16).  ``SSMScan`` on the CPU against
autograd through the plain forward, and the checkpoints against the scan's
own state, are exact up to the order of a sum.  The Mamba mixer's
gradients (every parameter and x) are held against ``jax.grad`` of
``repro.models.mamba.mamba_forward`` at 1e-4 of each leaf's largest
gradient, the model tests' tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v01_52b as jjamba
from repro.kernels import ops as jops
from repro.models import mamba as jmamba
from repro_torch.configs import jamba_v01_52b as tjamba
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.models import mamba as tmamba
from repro_torch.models.convert import params_from_jax

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
NAMES = ("u", "delta", "A", "B", "C", "D", "h0")
CASES = [(2, t, din, n) for t in (1, 37, 300) for din in (64, 200) for n in (4, 8, 16)]


def _inputs(case, seed=0):
    """u, delta, A, B, C, D, h0 and the cotangents dy, dhT, as numpy fp32."""
    bt, t, din, n = case
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(bt, t, din)), rng.random((bt, t, din)) * 0.1,
              -(rng.random((din, n)) + 0.5), rng.normal(size=(bt, t, n)),
              rng.normal(size=(bt, t, n)), rng.normal(size=(din,)),
              rng.normal(size=(bt, din, n)), rng.normal(size=(bt, t, din)),
              rng.normal(size=(bt, din, n))]
    return [a.astype(np.float32) for a in arrays]


def _cast(arrays, dtype, lib):
    """u, B, C and dy in ``dtype`` (the mixer's types), the rest fp32."""
    out = []
    for i, a in enumerate(arrays):
        low = dtype == "bfloat16" and i in (0, 3, 4, 7)
        if lib == "jax":
            out.append(jnp.asarray(a, jnp.bfloat16 if low else jnp.float32))
        else:
            x = torch.from_numpy(a)
            out.append(x.to(torch.bfloat16) if low else x)
    return out


def _jax_grads(arrays, dtype):
    *x, dy, dhT = _cast(arrays, dtype, "jax")
    _, vjp = jax.vjp(lambda *a: jops.ssm_scan(*a, impl="reference"), *x)
    return vjp((dy, dhT))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_matches_jax_vjp(case, dtype):
    arrays = _inputs(case)
    want = _jax_grads(arrays, dtype)
    *x, dy, dhT = _cast(arrays, dtype, "torch")
    _, _, ckpt = tssm.ssm_scan_plain(*x, checkpoints=True)
    got = tssm.ssm_scan_bwd_plain(*x, ckpt, dy, dhT)
    for name, g, w, inp in zip(NAMES, got, want, x):
        assert g.dtype == inp.dtype and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_function_on_cpu_matches_autograd_through_plain(dtype):
    arrays = _inputs((2, 70, 40, 16), seed=1)
    *x, dy, dhT = _cast(arrays, dtype, "torch")
    leaves = [a.clone().requires_grad_(True) for a in x]
    want = torch.autograd.grad(tssm.ssm_scan_plain(*leaves), leaves, (dy, dhT))
    before = (tssm.launches, tssm.bwd_launches)
    y, hT = ops.ssm_scan(*leaves)               # grad on: through SSMScan
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSMScanBackward"
    got = torch.autograd.grad((y, hT), leaves, (dy, dhT))
    assert (tssm.launches, tssm.bwd_launches) == before     # CPU: the plain versions
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), atol=1e-5, rtol=1e-5, msg=name)


def test_unused_final_state_gives_zero_dhT():
    """The model's loss ignores h_T: dhT arrives as zeros."""
    arrays = _inputs((1, 33, 16, 8), seed=2)
    *x, dy, _ = _cast(arrays, "float32", "torch")
    leaves = [a.clone().requires_grad_(True) for a in x]
    y, _ = tssm.SSMScan.apply(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    _, _, ckpt = tssm.ssm_scan_plain(*x, checkpoints=True)
    want = tssm.ssm_scan_bwd_plain(*x, ckpt, dy, torch.zeros_like(x[6]))
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("t", [1, 32, 33, 300])
def test_plain_checkpoints_are_the_state_at_each_boundary(t):
    *x, _, _ = _cast(_inputs((2, t, 24, 5), seed=3), "float32", "torch")
    y, hT, ckpt = tssm.ssm_scan_plain(*x, checkpoints=True)
    assert ckpt.shape == (2, tssm.n_chunks(t), 24, 5) and ckpt.dtype == torch.float32
    assert torch.equal(ckpt[:, 0], x[6])
    u, delta, A, B, C, D, h0 = x
    for k in range(1, ckpt.shape[1]):
        s = k * tssm.CHUNK
        _, h = tssm.ssm_scan_plain(u[:, :s], delta[:, :s], A, B[:, :s], C[:, :s], D, h0)
        assert torch.equal(ckpt[:, k], h), k
    y0, h0_ = tssm.ssm_scan_plain(*x)
    assert torch.equal(y, y0) and torch.equal(hT, h0_)


def test_mamba_mixer_gradients_match_jax_grad():
    """Every Mamba parameter's gradient and x's, on the jamba SMOKE layer's
    weights (carried by params_from_jax), against jax.grad of the reference
    mixer; the loss reaches y and the final state."""
    cfg = jjamba.SMOKE
    jp = jmamba.init_mamba(jax.random.key(0), cfg)
    layer = tmamba.Mamba(tjamba.SMOKE, device="meta")
    layer.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}),
                          assign=True)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    d_in = cfg.ssm.expand * cfg.d_model
    ry = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    rh = rng.normal(size=(2, d_in, cfg.ssm.d_state)).astype(np.float32)

    def jloss(p, xs):
        y, state = jmamba.mamba_forward(p, xs, cfg)
        return jnp.sum(y * ry) + jnp.sum(state["h"] * rh)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tcfg = dataclasses.replace(tjamba.SMOKE, attention_impl="reference")
    params = dict(layer.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    before = tssm.bwd_launches
    y, state = tmamba.mamba_forward(layer, tx, tcfg)
    loss = (y * torch.from_numpy(ry)).sum() + (state["h"] * torch.from_numpy(rh)).sum()
    grads = torch.autograd.grad(loss, [*params.values(), tx])
    assert tssm.bwd_launches == before
    want = {**{k: np.asarray(v) for k, v in jg.items()}, "x": np.asarray(jgx)}
    assert set(want) == set(params) | {"x"}
    for name, g in zip([*params, "x"], grads):
        w = want[name]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=1e-4, err_msg=name)
