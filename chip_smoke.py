#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py     # exits 0 only if every phase passed

Phases, each fatal on failure:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every hand kernel from src/repro_torch/kernels/csrc;
  3. kernels — each hand kernel against its plain torch version on the card at
               granite-3-2b's attention shapes (plus windowed and ragged cases),
               fp32 (TF32 off) and bf16, with the times of the kernel, the plain
               version and, as a yardstick only, F.scaled_dot_product_attention;
  4. model   — full-width granite-3-2b in fp32, prefill + 4 decode steps through
               the hand kernels and through the plain oracles on the same weights;
  5. engine  — the bf16 full-width InferenceEngine: cold start, 3 requests,
               scale to zero, snapshot restore, 1 more request (tokens equal to
               the first), with the kernels' launch counts over the whole run;
               then one more request timed and one traced (torch.profiler) for
               the device's busy share and kernel time by name;
  6. cluster — the batch simulator's cluster-step kernel against its plain
               torch version on the card: the reference tests' random fixtures
               (seeds 0-2) and one wide random table;
  7. batch   — the batch sweep driver on the card: batch_dense64 and
               batch_grid64 through run_sweep(..., driver="batch"), one kernel
               launch each; then each grid's built tables through the kernel
               and its plain version (state and aggregates compared, both
               timed), the sweep's summaries against the plain version's
               ledgers, the batch-vs-scalar spot check on four dense cells,
               and one traced batch call for the device's busy share.
Then one JSON line of kernel numbers and, last, the device JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "granite-3-2b"
MAX_SEQ, DECODE_STEPS, REQUESTS = 512, 16, 3
MODEL_PROMPT = 120          # model phase: ragged against 64-row tiles, decode writes land
# kernel vs plain version: tests/test_kernels.py's tolerances
KERNEL_TOL = {"float32": 3e-5, "bfloat16": 5e-2}
# model phase: fp32 logits of unit scale; the two paths run the same matmuls
# and differ only in the attention's summation order, 40 layers deep
MODEL_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# cluster step vs its plain version: the reference's own tolerance
# (tests/test_batchsim.py, Pallas twin vs oracle)
CLUSTER_TOL = dict(rtol=1e-4, atol=1e-2)
BATCH_GRIDS = ("batch_dense64", "batch_grid64")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _close(got, want, tol):
    """max |got - want| and whether |got - want| <= tol + tol * |want| holds."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= tol + tol * want.float().abs()).all())


def _time_ms(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def kernel_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import attention_mask

    gen = torch.Generator(device=dev).manual_seed(0)
    hq, hkv, d = 32, 8, 64                       # granite-3-2b attention
    flash_cases = [("prefill", 512, 512, None), ("window128", 512, 512, 128),
                   ("ragged", 24, 24, None), ("ragged_suffix", 24, 88, 16)]
    decode_cases = [("decode", 512, None), ("window128", 512, (300, 128)),
                    ("ragged", 24, (20, None))]
    timed = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for name, sq, skv, window in flash_cases:
            q = torch.randn((1, sq, hq, d), generator=gen, device=dev).to(tdt)
            k = torch.randn((1, skv, hkv, d), generator=gen, device=dev).to(tdt)
            v = torch.randn((1, skv, hkv, d), generator=gen, device=dev).to(tdt)
            q_pos = torch.arange(sq, device=dev, dtype=torch.int32) + (skv - sq)
            kv_pos = torch.arange(skv, device=dev, dtype=torch.int32)
            args = dict(causal=True, window=window, q_pos=q_pos, kv_pos=kv_pos)
            got = kf.flash_attention_hopper(q, k, v, **args)
            want = kf.flash_attention_plain(q, k, v, **args)
            torch.cuda.synchronize()
            err, ok = _close(got, want, KERNEL_TOL[dtype])
            print(f"kernel flash_attention {dtype} {name} Sq={sq} Skv={skv} "
                  f"window={window}: max_abs_err={err:.3e} tol={KERNEL_TOL[dtype]} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"flash_attention {dtype} {name} disagrees with its plain version")
            if dtype == "bfloat16" and name == "prefill":
                pairs = attention_mask(q_pos, kv_pos, causal=True, window=None).sum().item()
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                timed["flash_attention"] = dict(
                    max_abs_err=err,
                    ms=_time_ms(torch, lambda: kf.flash_attention_hopper(q, k, v, **args)),
                    plain_ms=_time_ms(torch, lambda: kf.flash_attention_plain(q, k, v, **args)),
                    library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)),
                    bound=_bound(4.0 * pairs * hq * d, _nbytes(q, k, v, got, q_pos, kv_pos),
                                 dtype))
        for name, s, mask_kind in decode_cases:
            q = torch.randn((1, hq, d), generator=gen, device=dev).to(tdt)
            k = torch.randn((1, s, hkv, d), generator=gen, device=dev).to(tdt)
            v = torch.randn((1, s, hkv, d), generator=gen, device=dev).to(tdt)
            idx = torch.arange(s, device=dev)
            if mask_kind is None:                 # the engine's pos >= max_seq case
                mask = torch.ones((1, s), dtype=torch.bool, device=dev)
            else:
                pos, window = mask_kind
                m = idx <= pos
                if window is not None:
                    m &= idx > pos - window
                mask = m[None].contiguous()
            got = kd.decode_attention_hopper(q, k, v, mask)
            want = kd.decode_attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            err, ok = _close(got, want, KERNEL_TOL[dtype])
            print(f"kernel decode_attention {dtype} {name} S={s}: max_abs_err={err:.3e} "
                  f"tol={KERNEL_TOL[dtype]} {'ok' if ok else 'FAIL'}")
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"decode_attention {dtype} {name} disagrees with its plain version")
            if dtype == "bfloat16" and name == "decode":
                n_valid = mask.sum().item()
                kv_rows = n_valid * hkv * d * k.element_size()
                qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
                amask = mask[:, None, None, :]
                timed["decode_attention"] = dict(
                    max_abs_err=err,
                    ms=_time_ms(torch, lambda: kd.decode_attention_hopper(q, k, v, mask)),
                    plain_ms=_time_ms(torch, lambda: kd.decode_attention_plain(q, k, v, mask)),
                    library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=amask, enable_gqa=True)),
                    bound=_bound(4.0 * n_valid * hq * d,
                                 _nbytes(q, got, mask) + 2 * kv_rows, dtype))
    for name, t in timed.items():
        print(f"time {name} bf16 (granite shape): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.5f} ms ({t['bound'][1]})")
    return timed


# --------------------------------------------------------------------------- #
# phase 4: full-width fp32 model, kernel path vs plain path
# --------------------------------------------------------------------------- #


def model_phase(torch, dev):
    from repro_torch.config import get_config
    from repro_torch.models import registry

    cfg = dataclasses.replace(get_config(ARCH), dtype="float32", param_dtype="float32")
    kernel = registry.build(cfg, max_seq=MAX_SEQ, device=dev)
    plain = registry.build(dataclasses.replace(cfg, attention_impl="oracle"),
                           max_seq=MAX_SEQ, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = kernel.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, MODEL_PROMPT), generator=gen, device=dev)
    with torch.inference_mode():
        lk, ck, pos = kernel.prefill(model, {"tokens": tokens})
        lp, cp, _ = plain.prefill(model, {"tokens": tokens})
        steps = [("prefill", lk, lp)]
        for i in range(4):
            tok = lk.argmax(-1)
            lk, ck = kernel.decode_step(model, ck, tok, pos + i)
            lp, cp = plain.decode_step(model, cp, tok, pos + i)
            steps.append((f"decode{i}", lk, lp))
        for name, a, b in steps:
            if a.shape != (1, cfg.vocab_size) or not torch.isfinite(a).all():
                _fail(f"model {name} logits: shape {tuple(a.shape)} or not finite")
            err, ok = _close(a, b, MODEL_TOL)
            print(f"model fp32 {name}: max |logit err| {err:.3e} (logit scale "
                  f"{b.abs().max().item():.3f}) tol={MODEL_TOL} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"full-width fp32 {name}: kernel path disagrees with plain path")
    del model, ck, cp
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 5: the bf16 full-width engine
# --------------------------------------------------------------------------- #


def engine_phase(torch):
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore

    cfg = get_config(ARCH)
    layers, vocab = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (1, MAX_SEQ)).astype(np.int32) for _ in range(REQUESTS)]

    def counts():
        return kf.launches, kd.launches

    def expect(what, before, flash, decode):
        got = tuple(a - b for a, b in zip(counts(), before))
        print(f"launches during {what}: flash_attention {got[0]}, decode_attention {got[1]} "
              f"(expected {flash}, {decode})")
        if got != (flash, decode):
            _fail(f"launch counts during {what}: {got} != {(flash, decode)}")

    with tempfile.TemporaryDirectory() as snapdir:
        eng = InferenceEngine(ARCH, smoke=False, max_seq=MAX_SEQ, batch=1,
                              store=SnapshotStore(snapdir), device="cuda")
        kf.launches = kd.launches = 0               # the main path starts here
        c = counts()
        bd = eng.cold_start()
        print(f"engine cold_start: {bd} (nvcc build {eng.build_s:.2f} s, set-up), "
              f"weights {eng.package_bytes() / 1e9:.3f} GB bf16")
        expect("cold_start (warm-up)", c, layers, layers)
        outs = []
        for i, p in enumerate(prompts):
            c = counts()
            out, st = eng.serve(p, decode_steps=DECODE_STEPS)
            print(f"engine serve {i}: prefill {st.prefill_s * 1e3:.2f} ms, decode "
                  f"{st.decode_s * 1e3:.2f} ms for {st.tokens} tokens "
                  f"({st.decode_s / st.tokens * 1e3:.3f} ms/token), tokens {out[0].tolist()}")
            expect(f"serve {i}", c, layers, layers * DECODE_STEPS)
            if out.shape != (1, DECODE_STEPS) or not ((out >= 0) & (out < vocab)).all():
                _fail(f"serve {i} tokens out of range: {out}")
            outs.append(out)
        eng.shutdown()
        c = counts()
        bd2 = eng.cold_start(from_snapshot=True)
        print(f"engine restore: {bd2}")
        expect("restore (warm key: no warm-up)", c, 0, 0)
        c = counts()
        out, st = eng.serve(prompts[0], decode_steps=DECODE_STEPS)
        print(f"engine serve after restore: prefill {st.prefill_s * 1e3:.2f} ms, decode "
              f"{st.decode_s * 1e3:.2f} ms, tokens {out[0].tolist()}")
        expect("serve after restore", c, layers, layers * DECODE_STEPS)
        if not np.array_equal(out, outs[0]):
            _fail(f"tokens after restore {out} != first request's {outs[0]}")
        total = counts()                              # read just after the main path
        n_serves = REQUESTS + 1
        want = (layers * (1 + n_serves), layers * (1 + n_serves * DECODE_STEPS))
        print(f"launches over the engine run: flash_attention {total[0]} "
              f"({layers}/prefill), decode_attention {total[1]} ({layers}/decode step)")
        if total != want:
            _fail(f"engine run launches {total} != {want}")
        profile_serve(torch, eng, prompts[1])
    return {"flash_attention": total[0], "decode_attention": total[1]}


def profile_serve(torch, eng, prompt):
    """Device busy share and kernel time by name over one warm request: the
    wall time from an unprofiled request, the kernel time from a traced one."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, st = eng.serve(prompt, decode_steps=DECODE_STEPS)
    wall_us = (st.prefill_s + st.decode_s) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.serve(prompt, decode_steps=DECODE_STEPS)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    if busy == 0:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile one serve: wall {wall_us / 1e3:.2f} ms (unprofiled), device "
          f"kernel time {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile   {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")


# --------------------------------------------------------------------------- #
# phase 6: the cluster-step kernel against its plain version
# --------------------------------------------------------------------------- #


def random_tables(rng, *, C=3, F=4, W=2, K=4, T=16, worker_mb=8192.0):
    """Randomized cluster-step state in the kernel's layout: arrivals with
    bursts, mixed tiers/edges/deadlines, partially-used workers.  A copy of
    ``tests/test_batchsim.py::_random_tables`` (the same draws in the same
    order, so the default worker size gives the same arrays), with the
    worker size open so that a wide table keeps free memory.  Returns the
    reference's order: nw, fs, free, arrivals, conc, promote, dwell, ntier,
    frac, scal, fparam."""
    import numpy as np
    from repro_torch.kernels import ref as R

    f32 = np.float32
    nw = (rng.integers(0, 3, (C, F, W))).astype(f32)
    fs = np.zeros((C, F, R.FS_N), f32)
    fs[:, :, R.FS_TIER] = rng.integers(1, 5, (C, F))
    fs[:, :, R.FS_EDGE] = rng.integers(0, K - 1, (C, F))
    fs[:, :, R.FS_DEADLINE] = rng.uniform(0.0, 6.0, (C, F))
    fs[:, :, R.FS_QUEUED] = rng.integers(0, 2, (C, F))
    arrivals = rng.poisson(0.7, (C, T, F)).astype(f32)
    conc = np.maximum(arrivals, rng.integers(0, 3, (C, T, F))).astype(f32)
    fparam = np.zeros((C, F, R.FP_N), f32)
    fparam[:, :, R.FP_MEM_MB] = rng.choice([256.0, 512.0, 1024.0], (C, F))
    fparam[:, :, R.FP_EXEC_S] = rng.uniform(0.05, 0.4, (C, F))
    fparam[:, :, R.FP_SVC] = np.maximum(
        np.floor(0.5 / fparam[:, :, R.FP_EXEC_S]), 1.0)
    fparam[:, :, R.FP_MEM_GB] = fparam[:, :, R.FP_MEM_MB] / 1024.0
    fparam[:, :, R.FP_EXEC_GB] = fparam[:, :, R.FP_MEM_GB]
    promote = np.sort(rng.uniform(0.01, 2.0, (C, F, 5)))[:, :, ::-1].copy()
    dwell = np.full((C, F, K), R.BIG_TIME, f32)
    dwell[:, :, :2] = rng.uniform(2.0, 20.0, (C, F, 2))
    ntier = np.zeros((C, F, K), f32)
    ntier[:, :, 0] = rng.choice([R.T_PAUSED, R.T_DEAD], (C, F))
    frac = np.tile(np.array([0.0, 0.02, 0.1, 0.3, 1.0], f32), (C, 1))
    scal = np.zeros((C, R.SC_N), f32)
    scal[:, R.SC_DT] = 0.5
    scal[:, R.SC_HORIZON] = T * 0.5 - rng.uniform(0.0, 2.0, C)
    free = np.full((C, W), worker_mb, f32)
    free -= (nw * fparam[:, :, R.FP_MEM_MB][:, :, None]).sum(axis=1)
    return (nw, fs, free.astype(f32), arrivals, conc,
            promote.astype(f32), dwell, ntier, frac, scal, fparam)


def kernel_order(tables):
    """``random_tables``' order -> the kernel's argument order."""
    nw, fs, free, arrivals, conc, promote, dwell, ntier, frac, scal, fparam = tables
    return nw, fs, free, arrivals, conc, fparam, promote, dwell, ntier, frac, scal


def table_args(tables):
    """A ``BatchTables``' arrays in the kernel's argument order."""
    return (tables.nw, tables.fs, tables.free, tables.arrivals, tables.conc,
            tables.fparam, tables.promote, tables.dwell, tables.ntier,
            tables.frac, tables.scal)


def _cluster_agree(got, want):
    """(max |err| over nw, fs, free, agg; all within CLUSTER_TOL and finite)."""
    import torch

    err, ok = 0.0, True
    for g, w in zip(got, want):
        err = max(err, (g - w).abs().max().item())
        ok &= bool(torch.isfinite(g).all()) and torch.allclose(g, w, **CLUSTER_TOL)
    return err, ok


def _cluster_bound(args, outs):
    """Least time for one launch on this run's inputs, over its active steps
    (those inside each cell's horizon): every input read once and every
    output written once, except ``conc``, which the kernel reads only in
    active steps; against the operations of the active steps, counted from
    the kernel's arithmetic (about 70 per function and 22 per (function,
    worker) pair in a step whose expiry walk stops at its first edge)."""
    import math

    from repro_torch.kernels import ref as R

    nw, arrivals, conc, scal = args[0], args[3], args[4], args[10]
    _, f, w = nw.shape
    t_steps = arrivals.shape[1]
    active = sum(min(t_steps, math.ceil(float(h) / float(dt)))
                 for h, dt in scal[:, [R.SC_HORIZON, R.SC_DT]].tolist())
    nbytes = (_nbytes(*(a for a in args if a is not conc), *outs)
              + active * f * conc.element_size())
    return _bound(active * f * (70 + 22 * w), nbytes, "float32")


def _cluster_compare(torch, name, args):
    """The kernel against its plain version on the same tables, fatal on a
    disagreement.  Returns (got, want, max |err|, plain ms): the one plain
    call that gives ``want`` is timed with CUDA events (it takes seconds)."""
    from repro_torch.kernels import cluster_step as kc

    got = kc.cluster_sim_hopper(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = kc.cluster_sim_plain(*args)
    stop.record()
    torch.cuda.synchronize()
    err, ok = _cluster_agree(got, want)
    c, f, w = args[0].shape
    print(f"cluster {name} C={c} F={f} W={w} K={args[7].shape[2]} T={args[3].shape[1]}: "
          f"max_abs_err={err:.3e} rtol={CLUSTER_TOL['rtol']} atol={CLUSTER_TOL['atol']} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        for nm, g, wt in zip(("nw", "fs", "free", "agg"), got, want):
            bad = ~torch.isclose(g, wt, **CLUSTER_TOL)
            print(f"cluster   {nm}: {int(bad.sum())} entries off, first at "
                  f"{bad.nonzero()[:3].tolist()}")
        _fail(f"cluster_step {name} disagrees with its plain version")
    return got, want, err, start.elapsed_time(stop)


def cluster_phase(torch, dev):
    """The fixtures and the wide table; the built grids' tables are held
    against the plain version in the batch phase."""
    import numpy as np

    cases = [(f"fixture{s}", kernel_order(random_tables(np.random.default_rng(s))))
             for s in range(3)]
    cases.append(("wide", kernel_order(random_tables(
        np.random.default_rng(3), C=64, F=256, W=64, K=8, T=256, worker_mb=262144.0))))
    for name, arrays in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        _cluster_compare(torch, name, args)


# --------------------------------------------------------------------------- #
# phase 7: the batch sweep driver
# --------------------------------------------------------------------------- #


def batch_phase(torch, dev):
    import numpy as np
    from repro_torch.core import batchsim
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import cluster_step as kc

    launches, timed = 0, None
    for grid in BATCH_GRIDS:
        kc.launches = 0                             # the main path starts here
        t0 = time.perf_counter()
        rows = list(runner.run_sweep(grid, driver="batch"))
        wall = time.perf_counter() - t0
        n = kc.launches                             # read just after the main path
        launches += n
        cells = registry.get_sweep(grid).scenarios()
        print(f"batch {grid}: {len(rows)} cells in {wall:.3f} s (run_sweep, driver=batch), "
              f"cluster_step launches {n}")
        if n != 1 or len(rows) != len(cells):
            _fail(f"{grid}: {n} kernel launches for {len(rows)} cells (expected 1 for "
                  f"{len(cells)})")
        # the same grid again, in parts, for the numbers and the plain comparison
        t0 = time.perf_counter()
        tables = batchsim.build_tables(cells, trace_fn=runner.build_trace)
        build_s = time.perf_counter() - t0
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in table_args(tables)]
        got, want, err, plain_ms = _cluster_compare(torch, grid, args)
        plain = batchsim.ledgers_from_agg(tables, *(x.cpu().numpy() for x in
                                                  (want[0], want[1], want[3])))
        worst = 0.0
        for (sc, s), led in zip(rows, plain):
            ref = runner.summarize(sc, led)
            for key, v in s.items():
                r = ref[key]
                if np.isnan(v) and np.isnan(r):
                    continue
                if not np.isfinite(v) or abs(v - r) > 1e-2 + 1e-4 * abs(r):
                    _fail(f"{grid} {sc.name} {key}: sweep {v} != plain {r}")
                worst = max(worst, abs(v - r))
        print(f"batch {grid}: sweep summaries vs plain-version ledgers: max |diff| "
              f"{worst:.3e} over {len(rows)} cells ok")
        kernel_ms = _time_ms(torch, lambda: kc.cluster_sim_hopper(*args), iters=20)
        bound = _cluster_bound(args, got)
        print(f"time cluster_step fp32 ({grid}): kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (one call), library none, bound {bound[0]:.5f} ms "
              f"({bound[1]})")
        if grid == "batch_dense64":
            timed = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=None, bound=bound)
        t0 = time.perf_counter()
        batchsim.simulate_batch(cells, trace_fn=runner.build_trace)
        sim_s = time.perf_counter() - t0
        invocations = sum(tables.invocations)
        print(f"batch {grid}: build_tables {build_s:.3f} s (traces cached), kernel "
              f"{kernel_ms:.4f} ms, simulate_batch wall {sim_s:.3f} s, {invocations} "
              f"invocations, {invocations / sim_s:.1f} invocations/s")
        _profile_batch(torch, sim_s,
                       lambda: batchsim.simulate_batch(cells, trace_fn=runner.build_trace))
    _spot_check(torch)
    return launches, timed


def _profile_batch(torch, wall_s, call):
    """Device busy share of one simulate_batch call (tables, copies, launch,
    ledgers): the device time from a traced call over the wall time of an
    unprofiled one (the first trace also pays the profiler's start-up)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy == 0:
        print("profile batch call: no device time recorded (not measured)")
        return
    print(f"profile batch call: wall {wall_s * 1e3:.2f} ms (unprofiled), device time "
          f"{busy / 1e3:.3f} ms, busy share {busy / (wall_s * 1e6):.5f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        print(f"profile   {us / 1e3:9.3f} ms  {name[:90]}")


def _spot_check(torch):
    """Batch vs scalar simulator on the four dense cells of BENCH_batchsim.json."""
    from repro_torch.core import batchsim
    from repro_torch.experiments import registry, runner

    recorded = {}
    bench = ROOT / "BENCH_batchsim.json"
    if bench.exists():
        recorded = {r["name"]: r for r in json.loads(bench.read_text())["spot_check"]}
    cells = registry.get_sweep("batch_dense64").scenarios()[::16][:4]
    t0 = time.perf_counter()
    rows = batchsim.spot_check(cells, trace_fn=runner.build_trace)
    print(f"spot_check {len(rows)} dense cells in {time.perf_counter() - t0:.2f} s "
          f"(batch on the card, scalar simulator on the host)")
    for r in rows:
        old = recorded.get(r.name, {})
        print(f"spot_check {r.name}: cold rate sim {r.cold_rate_sim:.6f} batch "
              f"{r.cold_rate_batch:.6f}; idle GB-s sim {r.idle_gb_s_sim:.2f} batch "
              f"{r.idle_gb_s_batch:.2f}; {'ok' if r.ok else 'FAIL'} | recorded batch (older "
              f"JAX code, CPU): cold {old.get('cold_rate_batch', float('nan')):.6f} idle "
              f"{old.get('idle_gb_s_batch', float('nan')):.2f}")
    if not all(r.ok for r in rows):
        _fail("spot_check: the batch driver is outside the tolerance contract")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"build: {build_s:.2f} s for {len(_build.SOURCES)} libraries "
          f"({time.perf_counter() - t0:.2f} s with checks)")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        text = log.read_text() if log.exists() else ""
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", text)]
        print(f"ptxas {name}: {len(regs)} kernels, registers <= {max(regs, default=0)}, "
              f"spill stores <= {max(spills, default=0)} bytes")

    timed = kernel_phase(torch, dev)
    model_phase(torch, dev)
    launches = engine_phase(torch)
    cluster_phase(torch, dev)
    launches["cluster_step"], timed["cluster_step"] = batch_phase(torch, dev)

    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:76",
                "decode_attention": "src/repro/kernels/decode_attention.py:57",
                "cluster_step": "src/repro/kernels/cluster_step.py:237"}
    kernels = []
    for name, t in timed.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
