"""The hand kernels against their plain torch versions, on a CUDA card.

A CUDA kernel has no CPU mode, so every test here skips without a card.  The
file imports neither JAX nor ``repro``, so it runs where only the port is
installed: ``python -m pytest -q tests/test_torch_gpu.py`` on the H100.
Tolerances are ``tests/test_kernels.py``'s (3e-5 fp32, 5e-2 bf16), with TF32
off so that the plain version's fp32 products are full fp32; at the long
shapes bf16 outputs are also held row by row (``chip_smoke.ROW_TOL`` of each
row's norm), a gate that refuses the kernel with its last key tile dropped.  The cluster step
is held at ``tests/test_batchsim.py``'s ``rtol=1e-4, atol=1e-2`` on random
cohort state from ``chip_smoke.random_tables`` (a numpy copy of that test's
fixture).  The selective scan is held at the scan's 5e-5 (fp32) and 5e-2
(bf16 u, B, C and y), with a nonzero h0; its backward at 1e-4 (fp32, the
flash backward's) and 5e-2 (bf16), with nonzero h0 and dhT, two calls
bit-equal.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cluster_step as tcluster
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ssm_scan as tssm

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
    (1, 1500, 1500, 20, 20, 64, False, None),  # whisper encoder: ragged 28-row tiles
    (1, 448, 1500, 20, 20, 64, False, None),  # whisper cross-attention
    (1, 448, 448, 20, 20, 64, True, None),    # whisper decoder self-attention
    (1, 512, 512, 14, 2, 64, True, None),     # internvl2: G 7
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


FLASH_EDGE_CASES = [
    # (b, sq, skv, hq, hkv, d, causal, window, shift): q_pos = arange(sq) +
    # (skv - sq) + shift, kv_pos = arange(skv)
    (1, 70, 70, 4, 2, 16, True, None, 0),        # D 16
    (2, 100, 100, 4, 2, 48, True, None, 0),      # D 48
    (1, 130, 130, 32, 8, 120, True, None, 0),    # D 120 (h2o-danube-3), ragged tiles
    (1, 200, 200, 32, 8, 128, True, None, 0),    # D 128 (the Jamba period)
    (2, 65, 129, 8, 2, 64, True, None, 0),       # Sq, Skv one past the 64-row tiles
    (1, 40, 300, 8, 2, 64, True, 50, 0),         # suffix, window: kv tiles 0-2 masked for every row
    (1, 40, 300, 8, 2, 120, True, 50, 0),
    (1, 70, 70, 4, 2, 64, True, 1, 3),           # window 1, shifted: 3 rows see no valid key
    (1, 70, 70, 4, 2, 128, True, 1, -80),        # no row sees a valid key
    (2, 96, 160, 8, 4, 64, False, None, 0),      # non-causal random: a wrong P layout shows
    (1, 77, 77, 12, 1, 128, False, None, 0),
    (1, 77, 77, 12, 1, 128, False, 20, 0),       # window without causality
]


@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_edge_cases_on_card(cuda, case, dtype):
    b, sq, skv, hq, hkv, d, causal, window, shift = case
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(DTYPES[dtype])
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    q_pos = torch.arange(sq, device=cuda, dtype=torch.int32) + (skv - sq) + shift
    kv_pos = torch.arange(skv, device=cuda, dtype=torch.int32)
    args = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
    before = tflash.launches
    got = tflash.flash_attention_hopper(q, k, v, **args)
    assert tflash.launches == before + 1
    want = tflash.flash_attention_plain(q, k, v, **args)
    out = got.float().cpu().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fp32_keeps_the_fp32_tolerance(cuda, d):
    """fp32 runs the plain-FMA kernel (tensor cores would round to TF32): it
    holds 3e-5 at granite's and the Jamba period's prefill shapes."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, 512, 32, d), generator=g, device=cuda)
    k, v = (torch.randn((1, 512, 8, d), generator=g, device=cuda) for _ in range(2))
    pos = torch.arange(512, device=cuda, dtype=torch.int32)
    got = tflash.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos)
    want = tflash.flash_attention_plain(q, k, v, q_pos=pos, kv_pos=pos)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=3e-5, rtol=3e-5)


DECODE_EDGE_CASES = [
    # (b, s, hq, hkv, d, mask): "rand" 3/4 valid, "chunk" rand with the second
    # chunk of 32 rows wholly masked, "none" every key masked
    (1, 512, 48, 4, 128, "rand"),     # starcoder2: G * D = 12 x 128
    (1, 512, 32, 8, 120, "rand"),     # h2o-danube-3: D 120
    (1, 500, 32, 8, 64, "rand"),      # S not a multiple of the 32-row chunk
    (1, 512, 32, 8, 64, "chunk"),
    (1, 512, 32, 8, 128, "none"),
    (3, 300, 32, 8, 64, "rand"),      # B 3
    (3, 777, 12, 1, 128, "chunk"),
    (2, 64, 96, 1, 128, "rand"),      # G * D = 12288
    (16, 300, 32, 8, 64, "chunk"),    # 3 splits of 100 rows: 4 tiles a block
    (40, 1000, 8, 8, 128, "rand"),    # a full batch: 1 split, 32 tiles a block
]


@pytest.mark.parametrize("case", DECODE_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_edge_cases_on_card(cuda, case, dtype):
    b, s, hq, hkv, d, kind = case
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
            for _ in range(2))
    mask = torch.rand((b, s), generator=g, device=cuda) > 0.25
    if kind == "chunk":
        chunk = -(-s // tdecode.decode_splits(b, s, hkv, tdecode._sms(cuda.index or 0)))
        mask[:, chunk:2 * chunk] = False
    if kind == "none":
        mask[:] = False
    before = tdecode.launches
    got = tdecode.decode_attention_hopper(q, k, v, mask)
    assert tdecode.launches == before + 1
    want = tdecode.decode_attention_plain(q, k, v, mask)
    out = got.float().cpu().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("case", DECODE_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_statistics_match_plain_on_card(cuda, case, dtype):
    """``stats=True``: the fp32 output and each row's (m, l) against the plain
    version's, at 1e-5 (both in fp32 from the same inputs); a row with no
    valid key has m = -1e30 and l = S exactly."""
    b, s, hq, hkv, d, kind = case
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
            for _ in range(2))
    mask = torch.rand((b, s), generator=g, device=cuda) > 0.25
    if kind == "chunk":
        chunk = -(-s // tdecode.decode_splits(b, s, hkv, tdecode._sms(cuda.index or 0)))
        mask[:, chunk:2 * chunk] = False
    if kind == "none":
        mask[:] = False
    before = tdecode.launches
    got = tdecode.decode_attention_hopper(q, k, v, mask, stats=True)
    assert tdecode.launches == before + 1
    want = tdecode.decode_attention_plain(q, k, v, mask, stats=True)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), atol=1e-5, rtol=1e-5)
    none = ~mask.any(dim=1)
    assert (got[1][none] == -1e30).all() and (got[2][none] == s).all()


MODEL_DECODE_CASES = [
    # (s, hq, hkv, d, valid rows): the encoder-decoder and vision shapes
    (1500, 20, 20, 64, 1500),   # whisper cross cache: all valid, 1500 = 46 x 32 + 28
    (448, 20, 20, 64, 448),     # whisper self cache past max_seq: all valid
    (448, 20, 20, 64, 121),     # whisper self cache mid-decode
    (512, 14, 2, 64, 300),      # internvl2: G 7 (G * D = 448)
    (512, 14, 2, 64, 512),
]


@pytest.mark.parametrize("case", MODEL_DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_the_encdec_and_vision_shapes(cuda, case, dtype):
    s, hq, hkv, d, n_valid = case
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k, v = (torch.randn((1, s, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
            for _ in range(2))
    mask = (torch.arange(s, device=cuda) < n_valid)[None].contiguous()
    before = tdecode.launches
    got = tdecode.decode_attention_hopper(q, k, v, mask)
    assert tdecode.launches == before + 1
    want = tdecode.decode_attention_plain(q, k, v, mask)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **_tol(dtype))


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


# around the warp kernel's 128-step chunk (T 1, 127-129, 300 with the horizon
# inside the second chunk), its lane and layout bounds (F 1, 5, 32, 33, 64,
# 65; W 1, 8 and 9; K 8), F not a multiple of 4 (4-byte cp.async instead of
# the bulk copy)
CLUSTER_EDGE_CASES = [
    dict(seed=10, T=1, horizon=10.0), dict(seed=11, T=127), dict(seed=12, T=128),
    dict(seed=13, T=129), dict(seed=14, F=5, W=3, T=300, horizon=100.0),
    dict(seed=15, C=2, F=1, W=1, T=40),
    dict(seed=16, C=2, F=32, W=8, K=8, T=140, worker_mb=65536.0),
    dict(seed=17, C=2, F=33, W=4, T=140, worker_mb=65536.0),
    dict(seed=18, C=2, F=64, W=8, K=8, T=130, worker_mb=131072.0),
    dict(seed=19, C=2, F=65, W=4, T=60, worker_mb=131072.0),
    dict(seed=20, C=2, F=20, W=9, T=60, worker_mb=32768.0),
]


@pytest.mark.parametrize("case", CLUSTER_EDGE_CASES, ids=lambda c: f"seed{c['seed']}")
def test_cluster_kernel_edge_cases_on_card(cuda, case):
    from repro_torch.kernels import ref as R

    kw = dict(case)
    seed, horizon = kw.pop("seed"), kw.pop("horizon", None)
    cs = _chip_smoke()
    tables = cs.kernel_order(cs.random_tables(np.random.default_rng(seed), **kw))
    if horizon is not None:
        tables[-1][:, R.SC_HORIZON] = horizon
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in tables]
    c, f, w = args[0].shape
    kind = tcluster.layout(f, w, args[7].shape[2])
    assert kind == ("warp" if f <= 64 and w <= 8 else "block")
    before = dict(tcluster.layout_launches)
    got = tcluster.cluster_sim_hopper(*args)
    assert tcluster.layout_launches[kind] == before[kind] + 1
    want = tcluster.cluster_sim_plain(*args)
    for name, g, wt in zip(("nw", "fs", "free", "agg"), got, want):
        out = g.cpu().numpy()
        assert np.isfinite(out).all(), name
        np.testing.assert_allclose(out, wt.cpu().numpy(), rtol=1e-4, atol=1e-2,
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


# the RL keep-alive gym's launch: a step offset and the per-function extras,
# in both layouts (warp: the fixtures; block: past the warp kernel's bounds)
CLUSTER_EXTRAS_CASES = [
    dict(seed=0, t_begin=5), dict(seed=1, t_begin=200),
    dict(seed=21, C=4, F=12, W=4, K=4, T=60, worker_mb=16384.0, t_begin=1140),
    dict(seed=22, C=2, F=70, W=4, T=60, worker_mb=131072.0, t_begin=60),
    dict(seed=23, C=2, F=20, W=9, T=60, worker_mb=32768.0, t_begin=7),
]


@pytest.mark.parametrize("case", CLUSTER_EXTRAS_CASES, ids=lambda c: f"seed{c['seed']}")
def test_cluster_extras_kernel_matches_plain_on_card(cuda, case):
    kw = dict(case)
    seed, t_begin = kw.pop("seed"), kw.pop("t_begin")
    cs = _chip_smoke()
    tables = cs.kernel_order(cs.random_tables(np.random.default_rng(seed), **kw))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in tables]
    c, f, w = args[0].shape
    kind = tcluster.layout(f, w, args[7].shape[2])
    before = dict(tcluster.layout_launches)
    got = tcluster.cluster_sim_hopper(*args, t_begin=t_begin, extras=True)
    assert tcluster.layout_launches[kind] == before[kind] + 1
    want = tcluster.cluster_sim_plain(*args, t_begin=t_begin, extras=True)
    assert tuple(got[4].shape) == (c, 2, f)
    for name, g, wt in zip(("nw", "fs", "free", "agg", "extras"), got, want):
        out = g.cpu().numpy()
        assert np.isfinite(out).all(), name
        np.testing.assert_allclose(out, wt.cpu().numpy(), rtol=1e-4, atol=1e-2,
                                   err_msg=name)
    # the extras-free launch gives the same state and aggregates
    four = tcluster.cluster_sim_hopper(*args, t_begin=t_begin)
    for a, b in zip(four, got):
        assert torch.equal(a, b)


def test_gym_baseline_is_one_launch_an_epoch_on_card(cuda):
    from repro_torch.learn.gym import BatchSimGym, training_scenarios

    kw = dict(seeds=(1, 2), horizon=120.0)
    gym = BatchSimGym(training_scenarios(**kw), device="cuda")
    before = tcluster.launches
    got = gym.baseline_rewards()
    assert tcluster.launches - before == len(gym.actions) * gym.num_epochs
    want = BatchSimGym(training_scenarios(**kw), device="cpu").baseline_rewards()
    for a in want:
        np.testing.assert_allclose(got[a]["reward"], want[a]["reward"], rtol=1e-4)
        np.testing.assert_allclose(got[a]["cold_starts"], want[a]["cold_starts"], atol=1e-2)


@pytest.mark.parametrize("b", [1, 64, 256])
def test_flash_kernel_at_the_forecaster_shape(cuda, b):
    """The gap forecaster's attention: fp32, (B, 16, 4, 8), causal, q_pos =
    kv_pos = arange(16)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((b, 16, 4, 8), generator=g, device=cuda) for _ in range(3))
    pos = torch.arange(16, device=cuda, dtype=torch.int32)
    before = tflash.launches
    got = tflash.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos)
    assert tflash.launches == before + 1
    want = tflash.flash_attention_plain(q, k, v, q_pos=pos, kv_pos=pos)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=3e-5, rtol=3e-5)


def test_forecaster_prediction_is_two_flash_launches_on_card(cuda):
    from pathlib import Path

    from repro_torch.core.predictors.transformer import TransformerPredictor

    ckpt = str(Path(__file__).resolve().parents[1] / "checkpoints" / "forecaster.npz")
    card = TransformerPredictor(ckpt, device="cuda")
    host = TransformerPredictor(ckpt, device="cpu")
    card.observe(0.0)
    host.observe(0.0)
    assert card.window() is None                  # no gap yet: no forward
    for t in (240.0, 480.0, 555.0, 795.0):
        card.observe(t)
        host.observe(t)
        before = tflash.launches
        got = card.window()
        assert tflash.launches - before == 2
        card.predict_next()                       # cached until the next arrival
        assert tflash.launches - before == 2
        np.testing.assert_allclose(got, host.window(), rtol=1e-5)


def _ssm_inputs(bt, t, din, n, dtype, device, seed=0):
    """u, B, C in ``dtype``; delta, A, D, h0 in fp32 (the Mamba mixer's types)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = [rng.normal(size=(bt, t, din)), rng.random((bt, t, din)) * 0.1,
              -(rng.random((din, n)) + 0.5), rng.normal(size=(bt, t, n)),
              rng.normal(size=(bt, t, n)), rng.normal(size=(din,)),
              rng.normal(size=(bt, din, n))]
    out = [torch.from_numpy(a.astype(f32)).to(device) for a in arrays]
    for i in (0, 3, 4):
        out[i] = out[i].to(DTYPES[dtype])
    return out


SSM_CASES = [(2, t, din, n) for t in (1, 37, 256, 300) for din in (64, 200) for n in (4, 8, 16)]
SSM_CASES += [(1, 512, 8192, 16), (3, 65, 96, 32), (1, 40, 24, 5)]   # jamba, N = 32, N odd


# around the 32-step chunk, the lanes a channel (N 1-4: 1, 5-8: 2, 9-16: 4,
# 17-32: 8) and ragged channel blocks (Din 24, 200 against 64 a block)
SSM_CASES += [(3, t, din, n) for t in (1, 31, 32, 33, 257) for n in (1, 5, 16, 17, 32)
              for din in (24, 200)]
# Din 100 in bf16: rows not 16-byte aligned at 4 lanes a channel (the
# element-by-element staging of the backward's ring); the two-layer Jamba's
# training shape
SSM_CASES += [(2, 33, 100, 16), (2, 257, 100, 32), (8, 256, 8192, 16)]


@pytest.mark.parametrize("case", SSM_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain_on_card(cuda, case, dtype):
    args = _ssm_inputs(*case, dtype, cuda)
    before = tssm.launches
    y, h = tssm.ssm_scan_hopper(*args)
    torch.cuda.synchronize()
    assert tssm.launches == before + 1
    want_y, want_h = tssm.ssm_scan_plain(*args)
    assert y.dtype == args[0].dtype and h.dtype == torch.float32
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(y.float().cpu().numpy(), want_y.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(), **tol)


def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _ssm_inputs(2, 8, 16, 4, "float32", cuda)
    with pytest.raises(ValueError, match="state size"):
        tssm.ssm_scan_hopper(*_ssm_inputs(1, 4, 8, 33, "float32", cuda))
    with pytest.raises(ValueError, match="is on"):
        tssm.ssm_scan_hopper(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        u = args[0].transpose(0, 1).contiguous().transpose(0, 1)
        tssm.ssm_scan_hopper(u, *args[1:])
    with pytest.raises(ValueError, match="must be"):
        tssm.ssm_scan_hopper(args[0][0], args[1][0], *args[2:])
    with pytest.raises(TypeError):
        tssm.ssm_scan_hopper(args[0].double(), *args[1:])
    with pytest.raises(TypeError, match="delta"):
        tssm.ssm_scan_hopper(args[0], args[1].bfloat16(), *args[2:])


def test_ssm_scan_on_cpu_tensors_launches_nothing():
    """A CPU tensor takes the plain version and counts no launch (no card needed)."""
    args = _ssm_inputs(1, 5, 8, 4, "float32", "cpu")
    before = tssm.launches
    y, h = tssm.ssm_scan_hopper(*args)
    assert tssm.launches == before
    want_y, want_h = tssm.ssm_scan_plain(*args)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


# the scan's backward against its plain version: fp32 sums over channels and
# time in another order (1e-4, the flash backward's); bf16 du, dB and dC are
# one rounding of an fp32 sum (5e-2)
SSM_BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _ssm_bwd_inputs(case, dtype, device, seed=0):
    args = _ssm_inputs(*case, dtype, device, seed=seed)
    rng = np.random.default_rng(seed + 1)
    bt, t, din, n = case
    dy = torch.from_numpy(rng.normal(size=(bt, t, din)).astype(np.float32)).to(device)
    dhT = torch.from_numpy(rng.normal(size=(bt, din, n)).astype(np.float32)).to(device)
    return args, dy.to(DTYPES[dtype]), dhT


@pytest.mark.parametrize("case", SSM_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_bwd_kernel_matches_plain_on_card(cuda, case, dtype):
    """The backward kernel against its plain version on the forward's
    checkpoints, nonzero h0 and dhT; two calls bit-equal."""
    args, dy, dhT = _ssm_bwd_inputs(case, dtype, cuda)
    y, hT, ckpt = tssm.ssm_scan_hopper(*args, checkpoints=True)
    before = tssm.bwd_launches
    got = tssm.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)
    again = tssm.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)
    torch.cuda.synchronize()
    assert tssm.bwd_launches == before + 2 * tssm.BWD_KERNELS
    want = tssm.ssm_scan_bwd_plain(*args, ckpt, dy, dhT)
    for name, a, b, w in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dh0"), got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, b), name
        np.testing.assert_allclose(a.float().cpu().numpy(), w.float().cpu().numpy(),
                                   err_msg=name, **SSM_BWD_TOL[dtype])


@pytest.mark.parametrize("case", SSM_CASES[::7], ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_checkpoints_leave_the_forward_bit_equal_on_card(cuda, case, dtype):
    """The forward with checkpoints gives serving's y and hT bit for bit, and
    checkpoints within the scan's tolerance of the plain version's."""
    args = _ssm_inputs(*case, dtype, cuda)
    y, hT = tssm.ssm_scan_hopper(*args)
    y2, hT2, ckpt = tssm.ssm_scan_hopper(*args, checkpoints=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    assert torch.equal(ckpt[:, 0], args[6])
    want = tssm.ssm_scan_plain(*args, checkpoints=True)[2]
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(ckpt.cpu().numpy(), want.cpu().numpy(), **tol)


def test_ssm_autograd_runs_the_backward_kernel_on_card(cuda):
    from repro_torch.kernels import ops

    (u, delta, A, B, C, D, h0), dy, dhT = _ssm_bwd_inputs((2, 70, 96, 16), "float32", cuda)
    leaves = [x.clone().requires_grad_(True) for x in (u, delta, A, B, C, D, h0)]
    f0, b0 = tssm.launches, tssm.bwd_launches
    y, hT = ops.ssm_scan(*leaves)
    grads = torch.autograd.grad((y, hT), leaves, (dy, dhT))
    assert (tssm.launches - f0, tssm.bwd_launches - b0) == (1, tssm.BWD_KERNELS)
    ckpt = tssm.ssm_scan_plain(u, delta, A, B, C, D, h0, checkpoints=True)[2]
    want = tssm.ssm_scan_bwd_plain(u, delta, A, B, C, D, h0, ckpt, dy, dhT)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, **SSM_BWD_TOL["float32"])


def test_snapshot_restores_from_pinned_copy_and_file_agree(cuda, tmp_path):
    """The snapshot store's two restore paths give the saved tensors: the
    pinned host copy (kept at save time) and the memory-mapped file (a store
    without that copy, as a new process has)."""
    from repro_torch.serving.engine import SnapshotStore

    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn((64, 48), generator=gen, device=cuda).bfloat16(),
             "b": torch.randn((47,), generator=gen, device=cuda),
             "i": torch.arange(7, device=cuda),
             "s": torch.tensor(3.5, device=cuda),
             "m": torch.randn((3, 5), generator=gen, device=cuda) > 0,
             "t": torch.randn((6, 4), generator=gen, device=cuda).t()}
    store = SnapshotStore(str(tmp_path))
    store.save_params("k", state)
    assert all(t.is_pinned() for t in store.host["k"].values())
    for source in (store, SnapshotStore(str(tmp_path))):
        got = source.load_params("k", cuda)
        torch.cuda.synchronize()
        assert set(got) == set(state)
        for name, t in got.items():
            assert t.device.type == "cuda" and t.dtype == state[name].dtype
            assert torch.equal(t, state[name]), name
    # the pinned image restores into one device buffer, each tensor aligned
    got = store.load_params("k", cuda)
    assert len({t.untyped_storage().data_ptr() for t in got.values()}) == 1
    assert all(t.data_ptr() % 256 == 0 for t in got.values())


def test_whisper_engine_decodes_past_the_position_table_on_card(cuda, tmp_path):
    """The engine decodes at max_seq + i, past whisper's learned positions:
    NaN logits (the reference's ``jnp.take`` fill), tokens 0 after the first,
    and no device-side assert (the context still runs kernels after)."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.serving.engine import InferenceEngine

    eng = InferenceEngine("whisper-large-v3", smoke=True, max_seq=16, store=None,
                          device="cuda")
    eng.cold_start()
    cfg = eng.bundle.cfg
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    frames = rng.standard_normal((1, cfg.encoder.num_frames,
                                  cfg.encoder.d_model)).astype(np.float32)
    before = kd.launches
    out, _ = eng.serve(tokens, decode_steps=4, extras={"frames": frames})
    torch.cuda.synchronize()
    assert kd.launches - before == 4 * 2 * cfg.num_layers
    assert out.shape == (1, 4) and (out[0, 1:] == 0).all()
    again, _ = eng.serve(tokens, decode_steps=4, extras={"frames": frames})
    np.testing.assert_array_equal(again, out)


def test_fuse_chain_graph_equals_its_eager_chain_on_card(cuda):
    """granite SMOKE -> h2o-danube-3 SMOKE as one CUDA graph: the replay's
    tokens equal the stages served one after another, for two inputs."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serving.engine import InferenceEngine, fuse_chain

    engines = []
    for arch in ("granite-3-2b", "h2o-danube-3-4b"):
        eng = InferenceEngine(arch, smoke=True, max_seq=16, store=None, device="cuda")
        eng.cold_start()
        engines.append(eng)
    before = kf.launches
    fn, compile_s = fuse_chain(engines, decode_steps=3)
    assert compile_s > 0 and kf.launches - before == 2 * (2 + 2)   # warm-up + capture
    for seed in range(2):
        tokens = np.random.default_rng(seed).integers(0, 1000, (1, 16)).astype(np.int32)
        got = fn({"tokens": tokens}).cpu().numpy()
        want = tokens
        for eng in engines:
            want = want % eng.bundle.cfg.vocab_size
            gen, _ = eng.serve(want, decode_steps=3)
            want = np.concatenate([want, gen], axis=1)[:, -16:]
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the flash backward kernel and the guard on the kernels with no backward
# --------------------------------------------------------------------------- #
BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# the forward's row statistics against the plain version's: fp32 sums in
# another order; in bf16 also ex2.approx (2^-22 relative) and m's trip
# through the kernel's log2 domain
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
FLASH_BWD_CASES = FLASH_CASES[:8] + [
    (1, 40, 40, 4, 2, 64, True, None, 16),    # keys start at 16: rows 0-15 see none
    (2, 16, 16, 4, 4, 8, True, None, 0),      # the forecaster's head shape
    (1, 24, 24, 32, 8, 120, True, None, 0),   # h2o-danube-3's D 120
    (1, 100, 300, 32, 8, 128, True, 64, 0),   # D 128, G 4, windowed, Sq < Skv
    (1, 200, 200, 14, 2, 64, True, None, 0),  # internvl2-1b's G 7
    (8, 256, 256, 32, 8, 64, True, None, 0),  # granite-3-2b's training shape
]


def _bwd_inputs(cuda, case, dtype, seed):
    """(q, k, v, out, dout, m, linv) and the mask arguments: out and the row
    statistics from the forward kernel, as FlashAttention saves them."""
    b, sq, skv, hq, hkv, d, causal, window = case[:8]
    shift = case[8] if len(case) > 8 else 0
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, dout = (torch.randn((b, sq, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
               for _ in range(2))
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
            for _ in range(2))
    q_pos = torch.arange(sq, device=cuda, dtype=torch.int32) + (skv - sq)
    kv_pos = torch.arange(skv, device=cuda, dtype=torch.int32) + shift
    args = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
    out, m, linv = tflash.flash_attention_hopper(q, k, v, **args, stats=True)
    return (q, k, v, out, dout, m, linv), args


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_statistics_match_plain_on_card(cuda, case, dtype):
    """With statistics on, the forward's output is bit-equal to its output
    with them off (serving's), and m, 1 / l match the plain version's."""
    (q, k, v, out, _, m, linv), args = _bwd_inputs(cuda, case, dtype, 6)
    assert torch.equal(out, tflash.flash_attention_hopper(q, k, v, **args))
    _, pm, pl = tflash.flash_attention_plain(q, k, v, **args, stats=True)
    for name, a, w in (("m", m, pm), ("linv", linv, pl)):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), err_msg=name, **STATS_TOL)


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain_on_card(cuda, case, dtype):
    tensors, args = _bwd_inputs(cuda, case, dtype, 7)
    before = tflash.bwd_launches
    got = tflash.flash_attention_bwd_hopper(*tensors, **args)
    assert tflash.bwd_launches == before + tflash.BWD_KERNELS
    want = tflash.flash_attention_bwd_plain(*tensors, **args)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        out = a.float().cpu().numpy()
        assert np.isfinite(out).all(), name
        np.testing.assert_allclose(out, w.float().cpu().numpy(), err_msg=name,
                                   **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_is_deterministic_on_card(cuda, dtype):
    tensors, args = _bwd_inputs(cuda, (2, 256, 256, 32, 8, 64, True, None), dtype, 8)
    first = tflash.flash_attention_bwd_hopper(*tensors, **args)
    second = tflash.flash_attention_bwd_hopper(*tensors, **args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_runs_the_backward_kernel_on_card(cuda):
    from repro_torch.kernels import ops

    (q, k, v, _, dout, m, linv), args = _bwd_inputs(cuda, FLASH_CASES[4], "float32", 9)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = tflash.launches, tflash.bwd_launches
    out = ops.flash_attention(*leaves, **args)
    grads = torch.autograd.grad(out, leaves, dout)
    assert (tflash.launches - f0, tflash.bwd_launches - b0) == (1, tflash.BWD_KERNELS)
    want = tflash.flash_attention_bwd_plain(q, k, v, out.detach(), dout, m, linv, **args)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, **BWD_TOL["float32"])


def test_kernels_with_no_backward_refuse_grad_on_card(cuda):
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn((1, 4, 64), generator=g, device=cuda, requires_grad=True)
    kc = torch.randn((1, 32, 2, 64), generator=g, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attention has no backward kernel"):
        ops.decode_attention(q, kc, kc, torch.ones((1, 32), dtype=torch.bool, device=cuda))
    cs = _chip_smoke()
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in cs.kernel_order(cs.random_tables(np.random.default_rng(0)))]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="cluster_step has no backward kernel"):
        tcluster.cluster_sim_hopper(*args)


def test_smoke_train_step_card_matches_cpu(cuda):
    """One SMOKE granite-3-2b train step on the card (flash forward and
    backward kernels) against the same step on the CPU: loss, gradient norm
    and the updated parameters."""
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step, param_tree, to_device

    host = registry.build_arch("granite-3-2b", smoke=True, max_seq=32, device="cpu")
    card = registry.build_arch("granite-3-2b", smoke=True, max_seq=32, device=cuda)
    p_host = host.init(torch.Generator().manual_seed(0))
    p_card = card.empty()
    p_card.load_state_dict({k: v.to(cuda) for k, v in p_host.state_dict().items()},
                           assign=True)
    batch = next(pipeline.batches(host.cfg, InputShape("t", 32, 2, "train")))
    opt = OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=1, eps=1e-3)
    f0, b0 = tflash.launches, tflash.bwd_launches
    _, _, mc = make_train_step(card, opt)(p_card, init_opt_state(param_tree(p_card)),
                                          to_device(batch, cuda))
    n = host.cfg.num_layers
    assert (tflash.launches - f0, tflash.bwd_launches - b0) == (n, tflash.BWD_KERNELS * n)
    _, _, mh = make_train_step(host, opt)(p_host, init_opt_state(param_tree(p_host)),
                                          to_device(batch, torch.device("cpu")))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[key]), float(mh[key]), rtol=1e-5, atol=1e-5)
    for name, p in p_card.state_dict().items():
        np.testing.assert_allclose(p.cpu().numpy(), p_host.state_dict()[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _meta_kernel_calls(device):
    """Every kernel wrapper (and both autograd Functions, forward and
    backward) on small tensors on ``device``: their outputs."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(14)

    def t(*shape, dtype=torch.float32, grad=False):
        return torch.randn(shape, generator=g, dtype=dtype).to(device).requires_grad_(grad)

    q, k, v = t(1, 64, 4, 64), t(1, 64, 2, 64), t(1, 64, 2, 64)
    pos = torch.arange(64, dtype=torch.int32).to(device)
    out = {"flash": tflash.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos)}
    o, m, linv = tflash.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos, stats=True)
    out["flash_stats"] = (o, m, linv)
    out["flash_bwd"] = tflash.flash_attention_bwd_hopper(q, k, v, o, o, m, linv, q_pos=pos,
                                                         kv_pos=pos)
    mask = torch.ones((1, 64), dtype=torch.bool).to(device)
    out["decode"] = tdecode.decode_attention_hopper(q[:, 0].contiguous(), k, v, mask)
    u, B, C = t(2, 40, 16), t(2, 40, 4), t(2, 40, 4)
    delta, A, D, h0 = t(2, 40, 16).abs() * 0.1, -t(16, 4).abs(), t(16), t(2, 16, 4)
    y, hT, ckpt = tssm.ssm_scan_hopper(u, delta, A, B, C, D, h0, checkpoints=True)
    out["ssm"] = (y, hT, ckpt)
    out["ssm_bwd"] = tssm.ssm_scan_bwd_hopper(u, delta, A, B, C, D, h0, ckpt, y, hT)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    ops.flash_attention(qg, kg, vg).sum().backward()
    out["flash_autograd"] = (qg.grad, kg.grad, vg.grad)
    ug = u.detach().requires_grad_(True)
    ops.ssm_scan(ug, delta, A, B, C, D, h0)[0].sum().backward()
    out["ssm_autograd"] = (ug.grad,)
    return out


def _counts():
    return (tflash.launches, tflash.bwd_launches, tdecode.launches, tssm.launches,
            tssm.bwd_launches)


def test_meta_branches_launch_nothing_on_card(cuda):
    """On the card's CUDA build, every wrapper and autograd Function on meta
    tensors gives the plain version's shapes and dtypes and launches
    nothing."""
    tflash.library(), tssm.library()                   # the libraries are built
    before = _counts()
    meta = _meta_kernel_calls("meta")
    assert _counts() == before
    cpu = _meta_kernel_calls("cpu")
    for name, got in meta.items():
        got = got if isinstance(got, tuple) else (got,)
        want = cpu[name] if isinstance(cpu[name], tuple) else (cpu[name],)
        assert [(x.shape, x.dtype, x.device.type) for x in got] == \
            [(x.shape, x.dtype, "meta") for x in want], name


def test_ep_one_rank_nccl_matches_single_device_on_card(cuda, tmp_path):
    """SMOKE jamba's loss and gradients through the expert-parallel MoE on a
    one-rank NCCL world equal the single-device path's (B 1 x S 2048 takes
    the EP path)."""
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, registry
    from repro_torch.training.train_loop import to_device, value_and_grad

    bundle = registry.build_arch("jamba-v0.1-52b", smoke=True, max_seq=2048, device=cuda)
    cfg = bundle.cfg
    shape = InputShape("ep", 2048, 1, "train")
    model = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    batch = to_device(next(pipeline.batches(cfg, shape)), cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        rules = sharding.make_rules(cfg, shape, mesh)
        assert rules["expert"] == "model"
        loss, _, grads = value_and_grad(bundle, model, batch)
        moe.allreduce_bytes.update(combine=0, backward=0)
        with sharding.use_rules(rules, mesh):
            ep_loss, _, ep_grads = value_and_grad(bundle, model, batch)
        assert moe.allreduce_bytes["combine"] > 0 and moe.allreduce_bytes["backward"] > 0
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(ep_loss.item(), loss.item(), rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(ep_grads[name].cpu().numpy(), g.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# the head shapes (Hq, Hkv, D) the four-architecture serves run, all at D 128:
# G 5, 8 (Hq * D = 4096 on d_model 2048) and 7, with 75-80 KB of shared memory
# a decode block (above the 48 KB default)
SERVED_HEADS = {"qwen2.5-14b": (40, 8, 128), "qwen3-moe-30b-a3b": (32, 4, 128),
                "arctic-480b": (56, 8, 128)}


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("arch", sorted(SERVED_HEADS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_the_served_heads_on_card(cuda, arch, b, dtype):
    """Flash (a 512-token prefill, a ragged windowed suffix) and decode (a
    512-row cache all valid, and ragged rows) against their plain versions at
    the served head shapes, B 1 and 8."""
    from repro_torch.config import get_config

    cfg = get_config(arch)
    hq, hkv, d = SERVED_HEADS[arch]
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (hq, hkv, d)
    g = torch.Generator(device=cuda).manual_seed(7)
    dt = DTYPES[dtype]
    for sq, skv, window in ((512, 512, None), (40, 130, 50)):
        q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dt)
        k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dt) for _ in range(2))
        args = dict(causal=True, window=window,
                    q_pos=torch.arange(sq, device=cuda, dtype=torch.int32) + (skv - sq),
                    kv_pos=torch.arange(skv, device=cuda, dtype=torch.int32))
        before = tflash.launches
        got = tflash.flash_attention_hopper(q, k, v, **args)
        assert tflash.launches == before + 1
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   tflash.flash_attention_plain(q, k, v, **args).float().cpu()
                                   .numpy(), **_tol(dtype))
    s = 512
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dt) for _ in range(2))
    last = 400 - 37 * torch.arange(b, device=cuda)[:, None]
    for mask in (torch.ones((b, s), dtype=torch.bool, device=cuda),
                 torch.arange(s, device=cuda) <= last):
        before = tdecode.launches
        got = tdecode.decode_attention_hopper(q, k, v, mask)
        assert tdecode.launches == before + 1
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   tdecode.decode_attention_plain(q, k, v, mask).float().cpu()
                                   .numpy(), **_tol(dtype))


def test_moe_layer_card_matches_cpu(cuda):
    """A qwen3-moe MoE layer (128 experts top-8, d_model cut to 256, expert_ff
    to 96) in fp32 on 512 tokens, card against CPU on the same weights
    (``chip_smoke.moe_card_vs_cpu``): a token routes apart only at a gap below
    ``MOE_GAP``, and the outputs agree within ``MOE_TOL`` of the largest where
    the routing agrees."""
    import dataclasses

    from repro_torch.config import get_config

    cs = _chip_smoke()
    full = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, d_model=256, dtype="float32", param_dtype="float32",
                              moe=dataclasses.replace(full.moe, expert_ff=96))
    r = cs.moe_card_vs_cpu(torch, cuda, cfg, 512)
    assert all(gap < cs.MOE_GAP for gap in r["gaps"]), r
    assert r["rel_err"] <= cs.MOE_TOL, r
    np.testing.assert_allclose(*r["aux"], rtol=1e-5)


# the config's long shapes: the flash forward at Skv 32768 (prefill_32k; a few
# heads, its plain version over q-row slices) and with the 4096 window over
# 8192 keys (long_500k's ring prefill, danube's D 120); the decode kernel at a
# 32768-row cache (decode_32k, B 1 and 8) and on a wrapped 4096-slot ring
# (every row valid); the flash backward at S 4096 (train_4k)
LONG_FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, window)
    (1, 32768, 32768, 4, 1, 64, None),
    (1, 8192, 8192, 8, 2, 120, 4096),
]
LONG_DECODE_CASES = [
    # (b, s, hq, hkv, d, last valid row)
    (1, 32768, 32, 8, 64, 32767),
    (8, 32768, 32, 8, 64, 32752),
    (1, 4096, 32, 8, 120, 4095),
]


def _assert_rows_close(got, want, bad=None):
    """bf16 at the long shapes: every row within ``chip_smoke.ROW_TOL`` of
    its own norm (the entries sit far below the absolute 5e-2), and ``bad``,
    the kernel with its last key tile dropped, refused by that gate."""
    cs = _chip_smoke()
    assert cs._row_err(got, want) <= cs.ROW_TOL
    if bad is not None:
        assert cs._row_err(bad, want) > cs.ROW_TOL


@pytest.mark.parametrize("case", LONG_FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_the_long_shapes_on_card(cuda, case, dtype):
    b, sq, skv, hq, hkv, d, window = case
    g = torch.Generator(device=cuda).manual_seed(20)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
            for _ in range(2))
    pos = torch.arange(skv, device=cuda, dtype=torch.int32)
    args = dict(causal=True, window=window, q_pos=pos[skv - sq:], kv_pos=pos)
    got = tflash.flash_attention_hopper(q, k, v, **args)
    want = tflash.flash_attention_plain_rows(q, k, v, **args)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == "bfloat16":
        # the kernel over every key but the last tile's 64 fails the row gate
        bad = tflash.flash_attention_hopper(q, k[:, :-64].contiguous(), v[:, :-64].contiguous(),
                                            **dict(args, kv_pos=pos[:-64]))
        _assert_rows_close(got, want, bad)


@pytest.mark.parametrize("case", LONG_DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_the_long_caches_on_card(cuda, case, dtype):
    b, s, hq, hkv, d, last = case
    g = torch.Generator(device=cuda).manual_seed(21)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(DTYPES[dtype])
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda).to(DTYPES[dtype])
            for _ in range(2))
    mask = (torch.arange(s, device=cuda) <= last)[None].expand(b, s).contiguous()
    got = tdecode.decode_attention_hopper(q, k, v, mask)
    want = tdecode.decode_attention_plain(q, k, v, mask)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == "bfloat16":
        # the kernel with the last valid 32-row tile masked out fails the row gate
        mask[:, last - 31:last + 1] = False
        _assert_rows_close(got, want, tdecode.decode_attention_hopper(q, k, v, mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_at_train_4k_on_card(cuda, dtype):
    """The backward at S 4096 (8 / 2 heads, D 64), fed the forward's
    statistics, against its plain version."""
    tensors, args = _bwd_inputs(cuda, (1, 4096, 4096, 8, 2, 64, True, None), dtype, 22)
    got = tflash.flash_attention_bwd_hopper(*tensors, **args)
    want = tflash.flash_attention_bwd_plain(*tensors, **args)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), w.float(), msg=name, **BWD_TOL[dtype])
        if dtype == "bfloat16":
            _assert_rows_close(a, w)


# --------------------------------------------------------------------------- #
# B 8: SMOKE whisper / internvl2 training, and engines row by row
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_smoke_train_at_batch_eight_kernel_matches_plain_on_card(cuda, arch):
    """The loss and every gradient of a SMOKE train batch of 8 rows through
    the hand kernels (the flash forward with its statistics, the backward
    kernels) against the oracle attention on the same weights and batch."""
    import dataclasses

    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.training.train_loop import to_device, value_and_grad

    kernel = registry.build_arch(arch, smoke=True, max_seq=32, device=cuda)
    cfg = kernel.cfg
    plain = registry.build(dataclasses.replace(cfg, attention_impl="oracle"), max_seq=32,
                           device=cuda)
    model = kernel.init(torch.Generator(device=cuda).manual_seed(0))
    batch = to_device(next(pipeline.batches(cfg, InputShape("t", 32, 8, "train"))), cuda)
    calls = cfg.num_layers if cfg.encoder is None else cfg.encoder.num_layers + 2 * cfg.num_layers
    f0, b0 = tflash.launches, tflash.bwd_launches
    lk, _, gk = value_and_grad(kernel, model, batch)
    assert (tflash.launches - f0, tflash.bwd_launches - b0) == (calls, tflash.BWD_KERNELS * calls)
    lp, _, gp = value_and_grad(plain, model, batch)
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5, atol=1e-5)
    for name, g in gp.items():
        np.testing.assert_allclose(gk[name].cpu().numpy(), g.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-large-v3", "internvl2-1b"])
def test_smoke_engine_at_batch_eight_matches_batch_one_on_card(cuda, arch):
    """A SMOKE (fp32) InferenceEngine built for B 8 against the same engine
    at B 1: each row's served tokens equal its prompt served alone, and each
    row's last logits after a 24-token prefill and 8 decode steps fed the
    same tokens lie within 1e-4 of its own at B 1.  A batch-stride or
    (batch, head) indexing fault in a kernel shows only at B > 1."""
    from repro_torch.serving.engine import InferenceEngine

    wide = InferenceEngine(arch, smoke=True, max_seq=32, batch=8, store=None, device="cuda")
    one = InferenceEngine(arch, smoke=True, max_seq=32, batch=1, store=None, device="cuda")
    wide.cold_start()
    one.cold_start()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, wide.bundle.cfg.vocab_size, (8, 32)).astype(np.int32)
    extras = {k: rng.standard_normal(shape).astype(np.float32)
              for k, (shape, _) in wide._prefill_batch_spec().items() if k != "tokens"}
    out, _ = wide.serve(tokens, decode_steps=4, extras=extras)
    for r in range(8):
        got, _ = one.serve(tokens[r:r + 1], decode_steps=4,
                           extras={k: v[r:r + 1] for k, v in extras.items()})
        np.testing.assert_array_equal(out[r], got[0])

    def run(eng, batch, fed):
        logits, caches, pos = eng.bundle.prefill(eng.params, batch)
        steps = [logits]
        for i in range(fed.shape[1]):
            logits, caches = eng.bundle.decode_step(eng.params, caches, fed[:, i], pos + i)
            steps.append(logits)
        return torch.stack(steps, dim=1)

    batch = {"tokens": torch.from_numpy(tokens[:, :24]).long().to(cuda),
             **{k: torch.from_numpy(v).to(cuda) for k, v in extras.items()}}
    fed = torch.from_numpy(tokens[:, 24:]).long().to(cuda)
    with torch.inference_mode():
        got = run(wide, batch, fed)
        for r in range(8):
            want = run(one, {k: v[r:r + 1] for k, v in batch.items()}, fed[r:r + 1])
            np.testing.assert_allclose(got[r].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"row {r}")


def test_cold_start_spans_on_card(cuda, monkeypatch):
    """On the card a cold start's log holds ``engine.build_check`` (no
    library compiled once they are built) and ``engine.deps_load`` with the
    allocator's new segments; the phase spans are the ``Breakdown``'s
    readings, and a request with the log synchronises as often as one
    without it."""
    from repro_torch.core.events import EventLog, validate_events
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import InferenceEngine

    _build.build()
    log = EventLog()
    eng = InferenceEngine("granite-3-2b", smoke=True, max_seq=32, store=None, device="cuda",
                          events=log)
    bd = eng.cold_start()
    spans = {e["name"]: e for e in log if e["kind"] == "span"}
    assert spans["engine.build_check"]["n"] == {"built": 0}
    outer = spans["engine.cold_start"]
    for name in ("engine.build_check", "engine.provision", "engine.deps_load",
                 "engine.code_init"):
        assert outer["start_ns"] <= spans[name]["start_ns"] <= spans[name]["end_ns"] \
            <= outer["end_ns"]
    for phase, seconds in bd.seconds.items():
        s = spans[f"engine.{phase.value}"]
        assert (s["end_ns"] - s["start_ns"]) / 1e9 == seconds
    # the allocator's block for a tensor may hold up to 1 MiB it did not split off
    n, tensors = spans["engine.deps_load"]["n"], len(eng.params.state_dict())
    assert eng.package_bytes() <= n["bytes"] <= eng.package_bytes() + 2**20 * tensors
    assert n["segments"] >= 0
    assert validate_events(log) == []

    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1) or real(*a, **k))
    tokens = np.ones((1, 32), np.int32)
    with_log, _ = eng.serve(tokens, decode_steps=4)
    counted = len(syncs)
    eng.events = None
    without, _ = eng.serve(tokens, decode_steps=4)
    assert len(syncs) == 2 * counted
    np.testing.assert_array_equal(with_log, without)
