"""The hand kernels against their plain torch versions, on a CUDA card.

A CUDA kernel has no CPU mode, so every test here skips without a card.  The
file imports neither JAX nor ``repro``, so it runs where only the port is
installed: ``python -m pytest -q tests/test_torch_gpu.py`` on the H100.
Tolerances are ``tests/test_kernels.py``'s (3e-5 fp32, 5e-2 bf16), with TF32
off so that the plain version's fp32 products are full fp32.  The cluster step
is held at ``tests/test_batchsim.py``'s ``rtol=1e-4, atol=1e-2`` on random
cohort state from ``chip_smoke.random_tables`` (a numpy copy of that test's
fixture).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cluster_step as tcluster
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=3e-5, rtol=3e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, causal, window)
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 128, 128, 4, 1, 64, True, 64),
    (1, 128, 384, 2, 2, 128, True, None),
    (1, 128, 128, 4, 4, 64, False, None),
    (3, 256, 256, 6, 2, 48, True, 128),
    (1, 24, 24, 4, 2, 64, True, None),
    (2, 24, 40, 8, 2, 32, True, 16),
    (1, 512, 512, 32, 8, 64, True, None),     # granite-3-2b prefill
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    b, sq, skv, hq, hkv, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
    q_pos = torch.arange(sq, device=cuda, dtype=torch.int32) + (skv - sq)
    kv_pos = torch.arange(skv, device=cuda, dtype=torch.int32)
    before = tflash.launches
    got = tflash.flash_attention_hopper(q, k, v, causal=causal, window=window,
                                        q_pos=q_pos, kv_pos=kv_pos)
    assert tflash.launches == before + 1
    want = tflash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        q_pos=q_pos, kv_pos=kv_pos)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


DECODE_CASES = [
    # (b, s, hq, hkv, d)
    (2, 512, 8, 2, 64),
    (1, 1024, 4, 4, 128),
    (3, 512, 8, 1, 32),
    (1, 24, 8, 2, 64),
    (1, 512, 32, 8, 64),                      # granite-3-2b decode
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_on_card(cuda, case, dtype):
    b, s, hq, hkv, d = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
    v = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
    mask = torch.rand((b, s), generator=g, device=cuda) > 0.25
    if b > 1:
        mask[1] = False
    before = tdecode.launches
    got = tdecode.decode_attention_hopper(q, k, v, mask)
    assert tdecode.launches == before + 1
    want = tdecode.decode_attention_plain(q, k, v, mask)
    out = got.float().cpu().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want.float().cpu().numpy(), **_tol(dtype))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    pos = torch.arange(8, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_hopper(q.transpose(1, 2), q.transpose(1, 2),
                                      q.transpose(1, 2), q_pos=pos[:4], kv_pos=pos[:4])
    with pytest.raises(TypeError):
        tflash.flash_attention_hopper(q.half(), q.half(), q.half(), q_pos=pos, kv_pos=pos)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CLUSTER_CASES = [
    dict(seed=0), dict(seed=1), dict(seed=2),          # the reference's fixtures
    dict(seed=3, C=4, F=16, W=8, K=6, T=64, worker_mb=16384.0),
    dict(seed=4, C=8, F=100, W=33, K=5, T=40, worker_mb=102400.0),
]


@pytest.mark.parametrize("case", CLUSTER_CASES, ids=lambda c: f"seed{c['seed']}")
def test_cluster_kernel_matches_plain_on_card(cuda, case):
    kw = dict(case)
    cs = _chip_smoke()
    tables = cs.kernel_order(cs.random_tables(np.random.default_rng(kw.pop("seed")), **kw))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in tables]
    before = tcluster.launches
    got = tcluster.cluster_sim_hopper(*args)
    assert tcluster.launches == before + 1
    want = tcluster.cluster_sim_plain(*args)
    for name, g, w in zip(("nw", "fs", "free", "agg"), got, want):
        out = g.cpu().numpy()
        assert np.isfinite(out).all(), name
        np.testing.assert_allclose(out, w.cpu().numpy(), rtol=1e-4, atol=1e-2,
                                   err_msg=name)


def test_cluster_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cs = _chip_smoke()
    tables = cs.kernel_order(cs.random_tables(np.random.default_rng(0)))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in tables]
    with pytest.raises(TypeError):
        tcluster.cluster_sim_hopper(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        tcluster.cluster_sim_hopper(args[0], args[1][:, :2], *args[2:])
    big = cs.kernel_order(cs.random_tables(np.random.default_rng(0), C=1, F=600, W=2, T=4))
    big = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in big]
    with pytest.raises(ValueError, match="at most"):
        tcluster.cluster_sim_hopper(*big)
