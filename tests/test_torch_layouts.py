"""The launch geometry of the port's cluster-step and selective-scan kernels,
on the CPU.

The kernels run only on a card, but the rules that pick their layout and
size their shared memory are pure Python (``cluster_step.layout`` /
``smem_bytes``, ``ssm_scan.scan_geometry`` and ``bwd_geometry``), mirrored
by the C side.  These tests hold every registered batch grid and every config
with a Mamba layer to those rules, and the rules to the constants in the CUDA
sources.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import ARCH_IDS, get_config
from repro_torch.core import batchsim
from repro_torch.experiments import registry, runner
from repro_torch.kernels import cluster_step as kc
from repro_torch.kernels import ssm_scan as ks

CSRC = Path(kc.__file__).resolve().with_name("csrc")
MAX_SMEM = 232448          # dynamic shared memory one H100 block can use


def _constants(name):
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / f"{name}.cu").read_text()):
        out.update((k, int(v)) for k, v in re.findall(r"(\w+) = (\d+)\b", decl))
    return out


def _batch_grids():
    """(name, F, W, K) of every registered sweep the batch driver takes."""
    out = []
    for name in registry.sweep_names():
        try:
            tables = batchsim.build_tables(registry.get_sweep(name).scenarios(),
                                           trace_fn=runner.build_trace)
        except batchsim.BatchUnsupportedPolicy:
            continue
        _, f, w = tables.nw.shape
        out.append((name, f, w, tables.dwell.shape[2]))
    return out


def test_every_registered_batch_grid_takes_the_warp_layout():
    grids = _batch_grids()
    assert {"batch_dense64", "batch_grid64"} <= {g[0] for g in grids}
    for name, f, w, k in grids:
        assert kc.layout(f, w, k) == "warp", (name, f, w, k)
        assert kc.smem_bytes("warp", f, w) <= MAX_SMEM, name


@pytest.mark.parametrize("shape,want", [
    ((1, 1, 1), "warp"), ((20, 4, 4), "warp"), ((40, 4, 4), "warp"),
    ((32, 8, 8), "warp"), ((33, 4, 4), "warp"), ((64, 8, 8), "warp"),
    ((65, 4, 4), "block"), ((20, 9, 4), "block"), ((20, 4, 9), "block"),
    ((100, 33, 5), "block"), ((256, 64, 8), "block")])
def test_cluster_layout_by_shape(shape, want):
    """The warp kernel up to F 64, W 8, K 8 (lane and register bounds); the
    block kernel beyond, the chip-smoke wide table (F 256, W 64) included."""
    assert kc.layout(*shape) == want
    assert kc.smem_bytes(want, shape[0], shape[1]) <= MAX_SMEM


def test_cluster_layout_refuses_what_neither_kernel_takes():
    with pytest.raises(ValueError, match="at most"):
        kc.layout(600, 2, 4)
    with pytest.raises(ValueError, match="shared memory"):
        kc.layout(512, 200, 4)
    with pytest.raises(ValueError, match="empty"):
        kc.layout(0, 4, 4)
    with pytest.raises(ValueError, match="unknown"):
        kc.smem_bytes("tile", 4, 4)


def test_cluster_warp_layout_fits_shared_memory_at_every_width():
    for f in range(1, kc.WARP_MAX["F"] + 1):
        for w in range(1, kc.WARP_MAX["W"] + 1):
            assert kc.layout(f, w, kc.WARP_MAX["K"]) == "warp"
            assert kc.smem_bytes("warp", f, w) <= MAX_SMEM


def test_cluster_rules_match_the_source():
    c = _constants("cluster_step")
    assert (c["WARP_MAX_F"], c["WARP_MAX_W"], c["WARP_MAX_K"]) == \
        (kc.WARP_MAX["F"], kc.WARP_MAX["W"], kc.WARP_MAX["K"])
    assert c["CHUNK"] == kc.CHUNK and c["MAX_THREADS"] == kc.MAX_THREADS


def test_cluster_step_on_cpu_tensors_counts_no_launch():
    """A CPU tensor takes the plain version: neither layout's counter moves."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tables = cs.kernel_order(cs.random_tables(np.random.default_rng(0), T=4))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in tables]
    before = (kc.launches, dict(kc.layout_launches))
    got = kc.cluster_sim_hopper(*args)
    assert (kc.launches, kc.layout_launches) == before
    for g, w in zip(got, kc.cluster_sim_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_scan_geometry_covers_every_state_size(itemsize):
    for n in range(1, ks.MAX_STATE + 1):
        geo = ks.scan_geometry(n, itemsize)
        lanes = geo["lanes"]
        assert lanes & (lanes - 1) == 0 and 32 % lanes == 0, n
        assert (lanes // 2) * geo["states"] < n <= lanes * geo["states"], n
        assert geo["threads"] == geo["channels"] * lanes <= 1024, n
        assert geo["smem_bytes"] <= MAX_SMEM, n
    for n in (0, ks.MAX_STATE + 1):
        with pytest.raises(ValueError, match="state size"):
            ks.scan_geometry(n, itemsize)


def test_scan_geometry_covers_every_mamba_config():
    mamba = [get_config(a) for a in ARCH_IDS if "M" in get_config(a).block_pattern]
    assert "jamba-v0.1-52b" in {c.name for c in mamba}
    for cfg in mamba:
        n = cfg.ssm.d_state
        d_inner = cfg.ssm.expand * cfg.d_model
        for itemsize in (2, 4):
            geo = ks.scan_geometry(n, itemsize)
            assert geo["smem_bytes"] <= MAX_SMEM, cfg.name
            # whole blocks of channels and 16-byte rows: the vector path
            assert d_inner % geo["channels"] == 0 and (n * itemsize) % 16 == 0, cfg.name
    jamba = get_config("jamba-v0.1-52b")
    geo = ks.scan_geometry(jamba.ssm.d_state, 2)
    assert (jamba.ssm.expand * jamba.d_model, geo["lanes"], geo["states"]) == (8192, 4, 4)


def test_scan_rules_match_the_source():
    c = _constants("ssm_scan")
    assert (c["CPB"], c["CHUNK"], c["STATES"], c["MAX_N"]) == \
        (ks.CHANNELS, ks.CHUNK, ks.STATES, ks.MAX_STATE)


def test_scan_bwd_rules_match_the_source():
    """The backward's constants and launch bounds are the ones
    ``ssm_scan.bwd_geometry`` mirrors, and it launches no cluster."""
    text = (CSRC / "ssm_scan_bwd.cu").read_text()
    c = _constants("ssm_scan_bwd")
    assert (c["CPB"], c["CHUNK"], c["SEG"], c["STATES"], c["MAX_N"]) == \
        (ks.CHANNELS, ks.CHUNK, ks.SEGMENT, ks.STATES, ks.MAX_STATE)
    assert (c["SMEM_PER_SM"], c["SMEM_RESERVED"]) == (ks.SMEM_PER_SM, ks.SMEM_RESERVED)
    # two blocks an SM where two fit at the lanes' largest N, else one
    assert "__launch_bounds__(cpb<L>() * L, min_blocks<T, L>())" in text
    assert "L < 8 && smem_bytes<T, L>(STATES * L) + SMEM_RESERVED <= SMEM_PER_SM / 2 ? 2 : 1" \
        in text
    assert "return L == 8 ? CPB / 2 : CPB;" in text
    assert "__cluster_dims__" not in text and "cudaLaunchKernelEx" not in text
    assert ks.bwd_geometry(16, 2)["cluster"] == 1


@pytest.mark.parametrize("itemsize", [2, 4])
def test_scan_bwd_geometry_fits_shared_memory_at_every_state_size(itemsize):
    """Every N 1-32 fits one block's 227 KB, and the SM's 228 KB at the blocks
    an SM the launch bounds ask for (1 KB reserved a block); a segment holds
    whole groups of L steps (the du / ddt reduce-scatter) and a chunk whole
    segments."""
    for n in range(1, ks.MAX_STATE + 1):
        geo = ks.bwd_geometry(n, itemsize)
        fwd = ks.scan_geometry(n, itemsize)
        assert geo["lanes"] == fwd["lanes"], n
        assert geo["channels"] == (ks.CHANNELS // 2 if geo["lanes"] == 8 else ks.CHANNELS), n
        assert geo["threads"] == geo["channels"] * geo["lanes"] <= 1024, n
        assert geo["smem_bytes"] <= MAX_SMEM, n
        assert geo["blocks_per_sm"] * (geo["smem_bytes"] + ks.SMEM_RESERVED) \
            <= ks.SMEM_PER_SM, n
        assert 1 <= geo["blocks_per_sm"] <= geo["bounds_blocks"], n
        assert geo["blocks_per_sm"] * geo["threads"] <= 2048, n
        assert ks.CHUNK % geo["segment"] == 0 and geo["segment"] % geo["lanes"] == 0, n
        assert geo["smem_bytes"] % 16 == 0, n


def test_scan_bwd_geometry_covers_every_mamba_config():
    mamba = [get_config(a) for a in ARCH_IDS if "M" in get_config(a).block_pattern]
    assert "jamba-v0.1-52b" in {c.name for c in mamba}
    for cfg in mamba:
        for itemsize in (2, 4):
            geo = ks.bwd_geometry(cfg.ssm.d_state, itemsize)
            assert geo["blocks_per_sm"] * (geo["smem_bytes"] + ks.SMEM_RESERVED) \
                <= ks.SMEM_PER_SM, cfg.name
            assert (cfg.ssm.expand * cfg.d_model) % ks.CHANNELS == 0, cfg.name
    jamba = get_config("jamba-v0.1-52b")
    geo = ks.bwd_geometry(jamba.ssm.d_state, 2)
    assert (jamba.ssm.expand * jamba.d_model, geo["lanes"], geo["threads"],
            geo["blocks_per_sm"]) == (8192, 4, 256, 2)
