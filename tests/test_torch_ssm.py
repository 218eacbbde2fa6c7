"""The port's selective scan and Mamba mixer against the JAX package's.

The same numpy inputs go through both.  The scan is held at
``tests/test_kernels.py``'s 5e-5 (abs and rel, fp32) against the JAX oracle,
the JAX chunked scan and the Pallas kernel in interpret mode: every version
carries an fp32 state through the same recurrence and differs only in the
rounding of exp and of the sum over N.  bf16 inputs are held at that file's
5e-2.  The decode step against one scan step is held at 2e-5.  The Mamba
mixer runs on the weights of the JAX package's jamba SMOKE layer, carried
across as numpy arrays under their own names; its outputs are compared at 1e-4, the model tests' tolerance (two fp32
projections either side of the scan).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v01_52b as jjamba
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import mamba as jmamba
from repro_torch.configs import jamba_v01_52b as tjamba
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.models import mamba as tmamba

TOL = dict(atol=5e-5, rtol=5e-5)

SSM_CASES = [
    # (bt, t, din, n): tests/test_kernels.py's, plus a ragged T and Din
    (2, 256, 256, 8),
    (1, 512, 512, 16),
    (2, 128, 1024, 4),
    (2, 37, 200, 8),
]


def _inputs(case, seed=0):
    bt, t, din, n = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(bt, t, din)).astype(f32),            # u
            (rng.random((bt, t, din)) * 0.1).astype(f32),         # delta
            -(rng.random((din, n)) + 0.5).astype(f32),            # A
            rng.normal(size=(bt, t, n)).astype(f32),              # B
            rng.normal(size=(bt, t, n)).astype(f32),              # C
            rng.normal(size=(din,)).astype(f32),                  # D
            rng.normal(size=(bt, din, n)).astype(f32))            # h0


@pytest.mark.parametrize("case", SSM_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssm_scan_matches_jax(case):
    x = _inputs(case)
    jx = [jnp.asarray(a) for a in x]
    tx = [torch.from_numpy(a) for a in x]
    want_y, want_h = jref.ssm_scan_ref(*jx)
    jax_versions = {"pallas": ssm_scan_pallas(*jx),
                    "jax reference": jops.ssm_scan(*jx, impl="reference")}
    before = tssm.launches
    ours = {"plain": tssm.ssm_scan_plain(*tx), "oracle": ref.ssm_scan_ref(*tx),
            "ops reference": ops.ssm_scan(*tx, impl="reference"),
            "ops pallas": ops.ssm_scan(*tx, impl="pallas"),
            "ops oracle": ops.ssm_scan(*tx, impl="oracle")}
    assert tssm.launches == before          # CPU tensors take the plain version
    for name, (y, h) in ours.items():
        assert y.dtype == torch.float32 and h.dtype == torch.float32, name
        for other, (oy, oh) in {"oracle": (want_y, want_h), **jax_versions}.items():
            np.testing.assert_allclose(y.numpy(), np.asarray(oy), err_msg=f"{name} vs {other}",
                                       **TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(oh), err_msg=f"{name} vs {other}",
                                       **TOL)


def test_ssm_scan_bf16_inputs_match_jax():
    """u, B, C in bf16 and delta, A, D, h0 in fp32, as the Mamba mixer calls it."""
    u, delta, A, B, C, D, h0 = _inputs((2, 64, 96, 16), seed=1)
    ju, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (u, B, C))
    tu, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, B, C))
    want_y, want_h = jref.ssm_scan_ref(ju, jnp.asarray(delta), jnp.asarray(A), jB, jC,
                                       jnp.asarray(D), jnp.asarray(h0))
    y, h = ops.ssm_scan(tu, *(torch.from_numpy(a) for a in (delta, A)), tB, tC,
                        torch.from_numpy(D), torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_ssm_step_matches_scan_and_jax(t):
    """t decode steps == the scan over t steps; one step == the JAX ssm_step."""
    u, delta, A, B, C, D, h0 = (torch.from_numpy(a) for a in _inputs((2, t, 64, 8), seed=2))
    h = h0
    for i in range(t):
        y, h = ops.ssm_step(u[:, i], delta[:, i], A, B[:, i], C[:, i], D, h)
    want_y, want_h = ref.ssm_scan_ref(u, delta, A, B, C, D, h0)
    np.testing.assert_allclose(y.numpy(), want_y[:, -1].numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), atol=2e-5, rtol=2e-5)
    args = (u[:, 0], delta[:, 0], A, B[:, 0], C[:, 0], D, h0)
    jy, jh = jops.ssm_step(*(jnp.asarray(a.numpy()) for a in args))
    ty, th = ops.ssm_step(*args)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)


def _mamba_pair(seed=0):
    cfg = jjamba.SMOKE
    jp = jmamba.init_mamba(jax.random.key(seed), cfg)
    layer = tmamba.Mamba(tjamba.SMOKE, device="meta")
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                          assign=True)
    return cfg, jp, layer


def test_mamba_parameters_carry_over_by_name():
    _, jp, layer = _mamba_pair()
    fresh = tmamba.Mamba(tjamba.SMOKE, device="cpu", gen=torch.Generator().manual_seed(0))
    assert set(fresh.state_dict()) == set(jp)
    for name, t in fresh.state_dict().items():
        assert tuple(t.shape) == jp[name].shape, name
        assert str(t.dtype).split(".")[1] == str(jp[name].dtype), name
    bf16 = dataclasses.replace(tjamba.SMOKE, param_dtype="bfloat16")
    kept = tmamba.Mamba(bf16, device="meta").state_dict()
    for name in ("dt_w", "dt_b", "A_log", "D"):
        assert kept[name].dtype == torch.float32, name
    assert kept["in_proj"].dtype == torch.bfloat16
    # A_log and dt_b are the reference's deterministic values (to an ulp of log)
    np.testing.assert_allclose(fresh.A_log.numpy(), np.asarray(jp["A_log"]), rtol=1e-6)
    np.testing.assert_allclose(fresh.dt_b.numpy(), np.asarray(jp["dt_b"]), rtol=1e-6)


@pytest.mark.parametrize("impl", ["reference", "oracle"])
@pytest.mark.parametrize("t", [1, 3, 12])
def test_mamba_forward_and_steps_match_jax(impl, t):
    """Prefill over t tokens (t < d_conv - 1 pads the conv state), then three
    decode steps from the prefill's state, on the jamba SMOKE layer."""
    cfg, jp, layer = _mamba_pair()
    tcfg = dataclasses.replace(tjamba.SMOKE, attention_impl=impl)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    steps = rng.normal(size=(3, 2, cfg.d_model)).astype(np.float32)
    jy, jstate = jmamba.mamba_forward(jp, jnp.asarray(x), cfg)
    with torch.inference_mode():
        ty, tstate = tmamba.mamba_forward(layer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    for key in ("conv", "h"):
        assert tuple(tstate[key].shape) == jstate[key].shape, key
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    for i, xs in enumerate(steps):
        jy, jstate = jmamba.mamba_step(jp, jnp.asarray(xs), jstate, cfg)
        with torch.inference_mode():
            ty, tstate = tmamba.mamba_step(layer, torch.from_numpy(xs), tstate, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {i} h")


def test_mamba_state_layout_matches_jax():
    cfg = jjamba.SMOKE
    want = jmamba.init_mamba_state(cfg, 3)
    got = tmamba.init_mamba_state(tjamba.SMOKE, 3, device="cpu")
    for key in ("conv", "h"):
        assert tuple(got[key].shape) == want[key].shape and not got[key].any(), key
        assert str(got[key].dtype).split(".")[1] == str(want[key].dtype), key


def test_softplus_has_no_linear_threshold():
    """jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus turns linear
    past 20 (equal in fp32 there, but not the same function)."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 60.0], np.float32)
    np.testing.assert_allclose(tmamba._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-7)
