"""The gradients the port trains with, against the JAX package's on the CPU.

* Flash attention: the plain forward's row statistics (m, 1 / l) rebuild
  the softmax that jnp computes from the same inputs, masks and NEG_INF
  sentinel (1e-5: fp32 sums in another order); ``flash_attention_bwd_plain``
  (the plain version of the hand backward kernel, and what
  ``FlashAttention.backward`` runs on a CPU tensor), fed those statistics,
  against ``jax.vjp`` of ``repro.kernels.ops._flash_reference`` (what the
  JAX package differentiates when it trains) and against
  ``torch.autograd.grad`` of ``flash_attention_plain``, on
  ``test_torch_kernels.py``'s cases plus rows that see no valid key.
  Tolerance 1e-4 in fp32 (both sides are fp32 arithmetic in another order)
  and 5e-2 in bf16 (the backward takes Dr = rowsum(dO * O) from the output
  as stored in bf16, the reference's autodiff from its fp32 value: about one
  bf16 ulp of O).
* The norms' backward against ``jax.vjp`` of the reference's custom-VJP
  ``_rmsnorm`` / ``_layernorm``: 1e-5 in fp32; in bf16 the same pointwise
  bf16 math and fp32 reductions, within one bf16 rounding (1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _flash_reference
from repro.kernels.ref import NEG_INF
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers

from test_torch_kernels import ATTN_CASES, REPAIRED_ATTN_CASES

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}

CASES = ATTN_CASES + REPAIRED_ATTN_CASES + [
    # (b, sq, skv, hq, hkv, d, causal, window, key shift): keys start at
    # position 16, so q rows 0-15 see no valid key (P = 1 / Skv on every key)
    (1, 40, 40, 4, 2, 64, True, None, 16),
    (2, 16, 16, 4, 4, 8, True, None, 0),       # the forecaster's head shape
]


def _inputs(case, dtype, seed):
    b, sq, skv, hq, hkv, d, causal, window = case[:8]
    shift = case[8] if len(case) > 8 else 0
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]
    q_pos = (np.arange(sq) + (skv - sq)).astype(np.int32)
    kv_pos = (np.arange(skv) + shift).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in arrays]
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx, (q_pos, kv_pos), dict(causal=causal, window=window)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


STATS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_statistics_rebuild_the_reference_softmax(case, dtype):
    """exp(s - m) * linv from the plain forward's statistics is jnp's softmax
    of the masked scores; a row with no valid key has m = NEG_INF exactly and
    weights each key by 1 / Skv; asking for the statistics leaves the output
    as it was."""
    (jq, jk, _, _), (tq, tk, tv, _), (q_pos, kv_pos), mode = _inputs(case, dtype, 6)
    b, sq, skv, hq, hkv, d = case[:6]
    g = hq // hkv
    mask = np.ones((sq, skv), bool)
    if mode["causal"]:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if mode["window"] is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - mode["window"]
    js = jnp.einsum("bqhgd,bkhd->bhgqk",
                    jq.astype(jnp.float32).reshape(b, sq, hkv, g, d) * (1.0 / d ** 0.5),
                    jk.astype(jnp.float32))
    js = jnp.where(jnp.asarray(mask)[None, None, None], js, NEG_INF)
    want_p = np.asarray(jax.nn.softmax(js, axis=-1)).reshape(b, hq, sq, skv)
    want_m = np.asarray(js.max(axis=-1)).reshape(b, hq, sq)

    pos = dict(q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos))
    out, m, linv = tflash.flash_attention_plain(tq, tk, tv, **mode, **pos, stats=True)
    assert m.shape == linv.shape == (b, hq, sq) and m.dtype == linv.dtype == torch.float32
    assert torch.equal(out, tflash.flash_attention_plain(tq, tk, tv, **mode, **pos))
    ts = torch.einsum("bqhgd,bkhd->bhgqk",
                      tq.float().reshape(b, sq, hkv, g, d) * (1.0 / d ** 0.5), tk.float())
    ts = torch.where(torch.from_numpy(mask), ts, NEG_INF).reshape(b, hq, sq, skv)
    got_p = torch.exp(ts - m[..., None]) * linv[..., None]
    np.testing.assert_allclose(got_p.numpy(), want_p, **STATS_TOL)
    np.testing.assert_allclose(m.numpy(), want_m, **STATS_TOL)
    unseen = ~mask.any(axis=1)
    assert (m.numpy()[:, :, unseen] == NEG_INF).all()
    np.testing.assert_allclose(linv.numpy()[:, :, unseen], 1.0 / skv, rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_matches_jax_vjp(case, dtype):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), (q_pos, kv_pos), mode = _inputs(case, dtype, 3)
    jout, vjp = jax.vjp(lambda q, k, v: _flash_reference(
        q, k, v, q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), **mode), jq, jk, jv)
    want = vjp(jdo)
    pos = dict(q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos))
    tout, tm, tl = tflash.flash_attention_plain(tq, tk, tv, **mode, **pos, stats=True)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL[dtype])
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, tout, tdo, tm, tl, **mode, **pos)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL[dtype])

    # the same gradient through autograd of the plain forward, and through
    # ops.flash_attention's autograd function (its CPU path)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tflash.flash_attention_plain(*leaves, **mode, **pos),
                               leaves, tdo)
    via_ops = torch.autograd.grad(ops.flash_attention(*leaves, **mode, **pos), leaves, tdo)
    for name, g, a, o in zip(("dq", "dk", "dv"), got, auto, via_ops):
        np.testing.assert_allclose(_np(g), _np(a), err_msg=name, **TOL[dtype])
        torch.testing.assert_close(o, g, rtol=0, atol=0)


def test_rows_with_no_valid_key_spread_dv_evenly():
    """A q row that sees no key weights every key by 1 / Skv: dv gets dO / Skv
    from it, dq and dk nothing."""
    b, sq, skv, hq, d = 1, 4, 6, 2, 8
    rng = np.random.default_rng(4)
    q, k, v, out_grad = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                         for s in ((b, sq, hq, d), (b, skv, hq, d), (b, skv, hq, d),
                                   (b, sq, hq, d)))
    pos = dict(q_pos=torch.arange(sq, dtype=torch.int32),
               kv_pos=torch.arange(skv, dtype=torch.int32) + 100)
    out, m, linv = tflash.flash_attention_plain(q, k, v, **pos, stats=True)
    assert (m == NEG_INF).all()
    dq, dk, dv = tflash.flash_attention_bwd_plain(q, k, v, out, out_grad, m, linv, **pos)
    assert torch.equal(dq, torch.zeros_like(dq)) and torch.equal(dk, torch.zeros_like(dk))
    want = out_grad.sum(1, keepdim=True).expand(b, skv, hq, d) / skv
    torch.testing.assert_close(dv, want, rtol=1e-6, atol=1e-6)


NORM_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_backward_matches_the_reference_vjp(kind, dtype):
    rng = np.random.default_rng(5)
    x, g = (rng.normal(size=(2, 7, 64)).astype(np.float32) for _ in range(2))
    scale = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = (0.1 * rng.normal(size=64)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jargs = [jnp.asarray(a, jdt) for a in ((x, scale) if kind == "rmsnorm" else (x, scale, bias))]
    fn = jlayers._rmsnorm if kind == "rmsnorm" else jlayers._layernorm
    jy, vjp = jax.vjp(fn, *jargs)
    want = vjp(jnp.asarray(g, jdt))

    params = tlayers.norm_init(64, kind, dtype, device="cpu")
    params.scale.data = torch.from_numpy(scale).to(tdt)
    if kind != "rmsnorm":
        params.bias.data = torch.from_numpy(bias).to(tdt)
    tx = torch.from_numpy(x).to(tdt)
    plain = tlayers.norm_apply(params, tx, kind)          # no grad wanted: no Function
    leaves = [tx.clone().requires_grad_(True)] + [p.requires_grad_(True)
                                                   for p in params.parameters()]
    y = tlayers.norm_apply(params, leaves[0], kind)
    assert torch.equal(y.detach(), plain)                 # the forward is unchanged
    np.testing.assert_allclose(_np(y.detach()), _np(jy), **NORM_TOL[dtype])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(tdt))
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), _np(w), err_msg=name, **NORM_TOL[dtype])
