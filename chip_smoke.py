#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py     # exits 0 only if every phase passed

Phases, each fatal on failure:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every hand kernel from src/repro_torch/kernels/csrc
               (ptxas registers and spills; HGMMA / UTMALDG counts in the flash
               forward's and backward's SASS, the backward's gated above 0);
  3. kernels — each hand kernel against its plain torch version on the card at
               the attention head shapes of granite-3-2b, the Jamba period,
               h2o-danube-3 (D 120) and starcoder2 (48/4 heads, D 128), with
               windowed and ragged cases, fp32 (TF32 off) and bf16; the bf16
               times of the kernel, the plain version and, as a yardstick only,
               F.scaled_dot_product_attention at granite's and Jamba's shapes;
               the selective scan on ragged fixtures and at the one-period
               Jamba prefill shape, fp32 and bf16, timed by CUDA-graph replay
               (device time) and launch by launch;
  4. model   — full-width granite-3-2b in fp32, prefill + 4 decode steps through
               the hand kernels and through the plain oracles on the same weights;
  5. engine  — the bf16 full-width InferenceEngine: cold start, 3 requests,
               scale to zero, snapshot restore, 1 more request (tokens equal to
               the first), with the kernels' launch counts over the whole run;
               then one more request timed and one traced (torch.profiler) for
               the device's busy share and kernel time by name;
  hybrid     — one full-width period of jamba-v0.1-52b (8 layers MMMMAMMM, MoE
               on the odd layers; only depth cut, from 32): in fp32, the kernel
               path against the plain path as in phase 4, with the smallest
               top-2 / top-3 router gap met; in bf16, registry.build's init /
               prefill / decode_step through the engine's request loop
               (engine.generate), 3 requests with exact launch counts and one
               traced; then the
               jamba SMOKE InferenceEngine (cold start, serve, snapshot restore,
               serve);
  6. cluster — the batch simulator's cluster-step kernel against its plain
               torch version on the card: the reference tests' random fixtures
               (seeds 0-2, the warp layout) and one wide random table (the
               block layout), each case naming its layout;
  7. batch   — the batch sweep driver on the card: batch_dense64 and
               batch_grid64 through run_sweep(..., driver="batch"), one kernel
               launch each (by layout); then each grid's built tables through
               the kernel and its plain version (state and aggregates
               compared; the kernel timed by graph replay and launch by
               launch, the plain version once), the sweep's summaries against the plain version's
               ledgers, the batch-vs-scalar spot check on four dense cells,
               and one traced batch call for the device's busy share;
  8. xlstm   — full-width xlstm-125m (12 layers LSLS..., no hand kernel on its
               path): in fp32, a 512-token prefill and 4 decode steps on the
               card against the same weights on the CPU, with ms per prefill
               and device launches per token; in bf16, the InferenceEngine
               (cold start, 3 requests, scale to zero, snapshot restore, 1
               request with the first's tokens; restore < cold start) and one
               traced request;
  9. facade  — a ServerlessRouter with full-width xlstm-125m and granite-3-2b:
               each COLD then warm (warm faster), granite's exact kernel
               launches; a ttl-0 router on the same store restores each
               (restore < cold start); format_summary;
 10. launcher — python -m repro_torch.launch.serve (SMOKE xlstm, ttl 0): three
               COLD lines and a summary;
 11. drivers — engine_smoke, calib/engine_paused and calib/engine_snapshot
               under the engine driver on the card (every invocation
               served), the cost model fitted from the two probes' events
               (analyze.calibrate, written to a temporary file) and the
               fidelity rows before and after;
 12. gym-kernel — the cluster step with a step offset and per-function
               extras against its plain version: the fixtures (warp layout)
               and the wide table (block layout); batch_dense64's tables in
               60-step epochs, kernel and plain version each chained, compared
               epoch by epoch, and the chain against one sweep launch; the
               extras-free sweep launch timed beside the extras launch;
 13. gym     — BatchSimGym(training_scenarios()) on the card:
               baseline_rewards with exactly one cluster-step launch an epoch
               (counted) and evaluate_schedule on the committed schedule,
               each against the same gym on the CPU; the gym's launch timed
               against its bound; train_agent (3 episodes) and
               export_schedule; wall per epoch and per episode, and the busy
               share of one traced episode;
 14. forecaster — the committed checkpoint read without JAX;
               apply_forecaster card vs CPU on 64 windows; 2 flash launches
               and the ms of a prediction; the learn scenario under
               prewarm_transformer (sim driver, predictors on the card; the
               flash launches counted) against the same run on the CPU, and
               one learn_grid cell under prewarm_lstm (horizon cut to 300 s);
 15. encdec  — full-width whisper-large-v3 (32 + 32 layers, 1500 frames,
               max_seq 448): in fp32, a 120-token prefill on random frames
               and 4 decode steps, kernel path vs plain path as in phase 4;
               the bf16 InferenceEngine with frames as in phase 5 (flash 96 a
               prefill, decode 64 a step; every token after the first is 0,
               the reference's NaN positions past max_seq; restore < cold
               start; one traced request); a ServerlessRouter COLD then warm
               request with extras={"frames": ...};
 16. vision  — full-width internvl2-1b (14/2 heads: G 7): fp32 kernel path
               vs plain path with 256 image embeddings, and the bf16 engine
               with image_embeds (flash 24 a prefill, decode 24 a step);
 17. chain   — fuse_chain over full-width granite-3-2b -> h2o-danube-3-4b
               (bf16, max_seq 512, 16 steps a stage) as one CUDA graph: its
               tokens against the stages run eagerly one after another, the
               capture's seconds, a replay's ms and the eager chain's.
 18. flash-bwd — the flash forward's row statistics (m, 1 / l; STATS_TOL)
               against its plain version's, its output with them bit-equal
               to its output without; the flash backward kernel
               (csrc/flash_attention_bwd.cu, fed those statistics) against
               its plain version on the kernel phase's flash cases, granite's
               training shape (B 8, S 256), the forecaster's (B 64, S 16, 4/4,
               D 8), a prefill whose first 40 rows see no valid key and
               train_4k's (B 8, S 4096; plain one batch row a call; in bf16
               also ROW_TOL, which must refuse the backward with its last key
               tile dropped), fp32 (1e-4) and bf16 (5e-2), each twice and
               bit-equal; the backward and the forward (with and without
               statistics) timed at granite's training shapes (bf16) and the
               forecaster's (fp32) beside the plain versions,
               scaled_dot_product_attention's (a yardstick only) and the
               simple SIMT backward it replaced;
 19. ssm-bwd — the scan's backward kernel (csrc/ssm_scan_bwd.cu, two
               launches: the reverse scan, the sums of its partials): every
               instantiation's registers and spills, the bf16 L 4 kernel's
               SHFL and MUFU.EX2 counts (at most 9 shuffles a step, each
               decay taken at most twice); against its plain version
               on the scan phase's fixtures, N 32, 5 and 1, the ring's edges
               (T 33, 257), unaligned rows (Din 100), SMOKE jamba's train
               shape and the Jamba training shape (Bt 8, T 256, Din 8192, N
               16), fp32 (1e-4) and bf16 (5e-2), nonzero h0 and dhT, each
               twice and bit-equal; the forward with checkpoints bit-equal in
               y and hT to serving's; both timed at the training shape (bf16)
               and SMOKE's (fp32) against bounds and the first, simple backward;
 20. train-grad — full-width granite-3-2b in fp32 at B 8 x S 256: bundle.loss
               and every leaf's gradient through the hand kernels (flash 2 a
               layer under remat, the backward BWD_KERNELS a layer) against
               the oracle attention on the same weights (loss 1e-5, grad norm
               1e-4 relative, every leaf within 1e-3 of its largest gradient);
 21. train   — 10 bf16 optimizer steps of full-width granite-3-2b through
               launch/train.py's main at its defaults (B 8 x S 256; AdamW in
               place): every loss, ms per step, tokens/s, peak memory beside
               the functional update's, exact launches (forward 80 a step,
               backward BWD_KERNELS x 40 kernels a step), the losses finite
               and falling; one more step traced (busy share, kernels by
               time);
 22. hybrid-train — full-width jamba-v0.1-52b cut to its first two layers
               (MM, 3.742 B parameters): phase 20 in fp32 at B 1 x S 256
               (scan kernels vs the oracle scan), then phase 21's 10 bf16
               steps through launch/train.py's train (scan forward 2 a Mamba
               layer a step under remat, its backward kernels once);
 23. forecaster-train — 10 steps of the forecaster's train step on the card
               and on the CPU from one set of weights (losses within 1e-4),
               then train_forecaster on the card with its launches counted;
 24. smoke-train — two train steps each of SMOKE whisper-large-v3,
               internvl2-1b and jamba-v0.1-52b (AM: attention, MoE, scan),
               card vs CPU (losses within 1e-4), launches exact;
 25. lifecycle — SMOKE granite-3-2b trained on the card, checkpointed, and
               served from the engine's SnapshotStore (the trained weights
               and the trained model's tokens);
 26. guard   — decode attention on card inputs that require grad raises (it
               has no backward kernel);
 27. ep      — a one-rank NCCL world (a FileStore in a temporary directory):
               the two-layer Jamba's fp32 loss and gradients at B 1 x S 2048
               through the expert-parallel MoE under use_rules(make_rules,
               make_host_mesh()) against the same call with no rules (phase
               20's tolerances), then one bf16 step through the EP path, with
               the all-reduce bytes it counted;
 28. dryrun  — launch/dryrun.py's spec pass over every architecture x shape
               on both production meshes (80 records: 66 ok, 14 skipped, 0
               errors); its meta pass of full-width granite-3-2b's and the
               two-layer Jamba's train step at B 8 x S 256 on one chip (no
               kernel launched), granite's argument bytes within 1% of what
               phase 21's parameters, AdamW state and batch held on the card;
 29. roofline — launch/roofline.py's bound on one H100 of granite-3-2b's
               train step, its prefill of 512 tokens and the two-layer
               Jamba's train step, each at or below the time phases 5, 21
               and 22 measured for it (bound, measured and their ratio
               printed);
 30. gspmd   — the GSPMD path (sharding.logical as DTensor placements, the
               parameters and batches placed by launch/specs.py, the hand
               kernels through local_map) on a one-rank NCCL world with a
               (1, 1) ("data", "model") mesh: c. granite-3-2b's bf16 512-token
               prefill against the plain prefill (logits and caches, 40 flash
               launches); a. granite fp32 at B 1 x S 256, loss and every
               gradient against phase 20's path (its tolerances; the largest
               difference printed); b. one bf16 train step at B 8 x S 256,
               launches equal to phase 21's a step, its ms beside phase 21's
               (DTensor's host cost, no gate); d. SMOKE jamba (AM) fp32, the
               loss and gradients on the card through DTensor against the
               CPU, the scan and its backward counted;
 31. gspmd-decode — decode under the decode rules: a. on phase 30's
               one-rank NCCL world, full-width granite-3-2b in bf16, a
               496-token prefill at max_seq 512, the caches placed by
               launch/specs.py's distribute_caches, then 16 decode steps
               through DTensor: logits and every cache leaf bit-equal to the
               plain decode_step, decode launches equal (40 a step), the ms a
               token beside the plain ms a token; b. the split softmax in one
               process at granite's and internvl2's (G 7) decode shapes, fp32
               and bf16: the decode kernel's statistics (stats=True) on 2 and
               4 row slices of a 512-row cache (some wholly masked), merged by
               ops.combine_partials, against the whole-cache kernel and the
               plain version (3e-5 / 5e-2), each slice's (out, m, l) against
               the plain version's (1e-5; m = -1e30, l = the rows exactly on a
               masked slice); the statistics instantiation timed beside the
               serving one (graph replay and launch by launch).
 32-35. qwen2.5-14b, starcoder2-15b, qwen3-moe-30b-a3b, arctic-480b (ARCHS),
               one resident at a time, weights from seed 0 on the card: in
               fp32 (qwen3-moe cut to 24 layers, arctic to 1), a 120-token
               prefill and 4 decode steps through the hand kernels against
               the plain path at B 1 and at B 8 (eight prompts in one call),
               logits within 1e-3, the init's peak within 1% of the weights,
               an MoE's smallest router gap printed; in bf16 at max_seq 512
               (arctic cut to 2 layers), a warm-up, 3 requests at B 1 and one
               at B 8 with exact launches (a prefill's layers, a step's
               layers each step), tokens in range, finite logits, one traced
               request: qwen2.5-14b through the InferenceEngine (cold start,
               snapshot restore serving the first request's tokens, the
               restore's and the cold start's totals printed, not gated;
               host memory and the temporary directory's room printed before
               its snapshot), the others through its request loop
               (engine.generate);
 36. moe     — one full-width qwen3-moe MoE layer in fp32 (128 experts top-8)
               on 512 tokens, card against CPU on the same weights: each
               token routed apart shown with its k-th / (k+1)-th probability
               gap (below 1e-6), the outputs where the routing agrees within
               1e-5 of the largest, both aux losses.
 37. long-kernels — the config's own long shapes (config.SHAPES), kernel
               against plain version, fp32 and bf16: flash at Skv 32768 (B 1)
               and 32752 (B 8) and with the 4096 window over 8192 keys
               (danube's D 120, Jamba's D 128), the plain version over q-row
               slices (flash_attention_plain_rows; B 8 in bf16 only); decode
               at 32768 rows (B 8, B 1) and on the wrapped 4096-slot ring;
               the scan at T 8192; bf16 attention also row by row (ROW_TOL),
               a gate that must refuse the kernel with its last key tile
               dropped; the bf16 calls timed with bounds and SDPA, flash's
               prologue by the same call with window 1;
 38. prefill_32k — full-width granite-3-2b, bf16, B 1 x 32768 through
               registry.build(cfg, SHAPES["prefill_32k"]): two prefills, 40
               flash launches each, the roofline's bound beside the time; then
               in fp32 at 4 layers the last logits of a prefill of S tokens
               against a prefill of S - 16 and 16 decode steps (1e-3);
 39. decode_32k — granite bf16, 8 prompts of 32752 tokens at max_seq 32768,
               16 decode steps (40 decode launches each) through
               engine.generate, ms a token, peak, the decode steps' idle share
               from a traced second run; the fp32 check at B 8 x 32768 (4
               layers);
 40. train_4k — granite bf16 weights, fp32 AdamW, remat, S 4096 at the
               largest B of 8, 4, 2, 1 that fits (each failure printed), 5
               steps through launch/train.py, exact launches, one traced step,
               the roofline's bound (its flash kernels are held and timed
               at (8, 4096) in phase 18);
 41. long_500k — h2o-danube-3-4b (full) and one Jamba period, built with
               SHAPES["long_500k"] (4096-slot rings): an 8192-token prompt and
               16 decode steps, exact launches, ms a token, peak, idle share;
               the fp32 check at S 8192 (Jamba's MoE capacity raised so that
               no token drops; its smallest router gap printed).
 42-43. train whisper-large-v3, internvl2-1b — full width: the fp32 loss
               and every gradient at B 1 (S 256; internvl2 S 512) through the
               hand kernels against the plain path (GRAD_TOL), then 5 bf16
               steps through launch/train.py's main at B 8 (internvl2 at S
               512: its 256 image positions come first) writing --checkpoint:
               exact launches, finite falling losses, ms a step, tokens/s,
               peak GB, one traced step, the roofline's bound beside it;
 44. train xlstm-125m — full width: fp32 gradients card vs CPU at 2 layers
               and S 64 (the sLSTM input gate's bias, whose exact gradient is
               0, held to a floor), then 2 bf16 steps at the largest of B 8,
               4, 2, 1 that fits (no hand kernel; host-bound);
 45. engine-b8 — the bf16 InferenceEngine built with batch=8 for granite-3-2b,
               whisper (frames) and internvl2 (image embeds): cold start with
               the warm-up at the B 8 spec, 3 requests of 8 prompts, restore,
               the first request again (equal tokens), the tokens against
               engine.generate's, rows not all equal, exact launches (a B 8
               request launches what a B 1 request does), ms a token, one
               traced request; restore vs cold start printed, not gated;
 46. rows    — each of those models in fp32 cut to 4 layers (whisper 4 + 4):
               8 prompts in one prefill and 16 decode steps against each row
               alone, last logits within 1e-3; the gate must refuse the B 8
               logits with two rows swapped;
 47. serve-trained — whisper's and internvl2's checkpoints from phases
               42-43 loaded into a SnapshotStore under a B 8 engine's key (at
               the trained length), cold-started from it and served: weights
               equal the checkpoint's, tokens equal engine.generate's on the
               checkpoint's weights, exact launches.
The kernel phase also holds the flash kernel to its plain version at the
forecaster's shape (fp32, (B, 16, 4, 8), B 1 and 256) and times it, and
both attention kernels at whisper's (encoder 1500 x 1500 non-causal, cross
448 x 1500, decoder 448; decode against the 1500-row cross cache and the
448-row self cache) and internvl2's (G 7) shapes, bf16 timed; and at the
four served architectures' shapes (qwen2.5 G 5, starcoder2 G 12, qwen3-moe
G 8, arctic G 7, all D 128) at B 1 and 8, their prefill and decode timed,
and at the B 8 engines' shapes (granite, whisper's encoder, cross and
decoder, internvl2; decode against each B 8 cache), timed; the backward
phase adds whisper's and internvl2's B 8 training shapes, timed.
The granite engine phase also restores from the snapshot file alone (a store
with no pinned host copy, as a new process has) beside the pinned restore,
and holds the pinned restore under the cold start (C2).
Then one JSON line of kernel numbers and, last, the device JSON line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# ... and in bf16 at the long shapes, each output row's error relative to its
# own norm (``_row_err``): a row averaging n keys of unit-scale values has
# entries near n^-1/2 (~0.006 at 32768), far under the bf16 gate's absolute
# 5e-2, so a kernel that skipped a key tile would pass that gate alone (fp32's
# 3e-5 refuses it).  1e-2 is about 2.5 of bf16's 2^-8 relative spacing: the
# output's rounding and the kernels' bf16 P in the PV product, ~2^-9 each
ROW_TOL = 1e-2
# model phase: fp32 logits of unit scale; the two paths run the same matmuls
# and differ only in the attention's summation order, 40 layers deep
MODEL_TOL = 1e-3
# the selective scan vs its plain version: tests/test_kernels.py's scan tolerance
# (fp32); bf16 is one rounding of y, held at the attention kernels' 5e-2
SSM_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
# one full-width period of the hybrid family: every width kept, depth 32 -> 8
HYBRID, HYBRID_LAYERS = "jamba-v0.1-52b", 8
# cluster step vs its plain version: the reference's own tolerance
# (tests/test_batchsim.py, Pallas twin vs oracle)
CLUSTER_TOL = dict(rtol=1e-4, atol=1e-2)
BATCH_GRIDS = ("batch_dense64", "batch_grid64")
# the xLSTM family at full width: fp32 card vs CPU on one set of weights over
# 512 steps (the model phase's tolerance), its depth cut 12 -> 4 (two mLSTM +
# sLSTM pairs) for the script's time limit
XLSTM = "xlstm-125m"
XLSTM_CHECK_LAYERS = 4
ENGINE_DRIVER_CELLS = ("engine_smoke", "calib/engine_paused", "calib/engine_snapshot")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _close(got, want, tol):
    """max |got - want| and whether |got - want| <= tol + tol * |want| holds."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= tol + tol * want.float().abs()).all())


def _row_err(got, want) -> float:
    """The largest ||got - want|| over rows (the last dim), each relative to
    its row's norm or to a hundredth of the rows' root-mean-square norm,
    whichever is larger: a row whose exact value is zero (the first q row's
    dq: one key, so no gradient through its softmax) has no scale of its own."""
    g, w = got.float(), want.float()
    norm = w.norm(dim=-1)
    floor = 1e-2 * norm.square().mean().sqrt()
    return ((g - w).norm(dim=-1) / norm.maximum(floor)).max().item()


def _long_close(got, want, dtype, tol=KERNEL_TOL, rows=True):
    """The kernel gate (``_close`` at ``tol[dtype]``) and, in bf16 with
    ``rows``, the row gate (``_row_err`` within ROW_TOL): (max abs error, row
    error or None, ok)."""
    err, ok = _close(got, want, tol[dtype])
    if dtype != "bfloat16" or not rows:
        return err, None, ok
    row = _row_err(got, want)
    return err, row, ok and row <= ROW_TOL


def _rows(row) -> str:
    return "" if row is None else f", row error {row:.3e} (ROW_TOL {ROW_TOL})"


def _gate_rejects(what, dtype, bad, want, tol=KERNEL_TOL):
    """The gates' check on a kernel's output with its last key tile dropped
    (``bad``): the row gate must refuse it; whether KERNEL_TOL alone would
    have is printed beside."""
    err, ok = _close(bad, want, tol[dtype])
    row = _row_err(bad, want)
    print(f"gate {what} {dtype}, the kernel with its last key tile dropped: row error "
          f"{row:.3e} (ROW_TOL {ROW_TOL}: refused {not row <= ROW_TOL}); max_abs_err "
          f"{err:.3e} (the absolute gate alone would pass it: {ok})")
    if row <= ROW_TOL:
        _fail(f"{what} {dtype}: the row gate passes the kernel with its last key tile dropped")


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


def _event_ms(torch, fn) -> float:
    """Device ms of one ``fn()`` between CUDA events (a call too large to
    repeat or to capture)."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _graph_ms(torch, fn, reps: int = 20, iters: int = 10) -> float:
    """Device ms of one ``fn()``: ``reps`` calls captured in a CUDA graph, the
    graph replayed ``iters`` times between CUDA events.  Unlike ``_time_ms``
    it leaves out the host's cost of each call (Python, the wrapper's checks,
    the launch), which for a kernel of a few microseconds is most of a
    launch-by-launch loop."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


def _attn_times(torch, kernel, plain, library, *, reps=20, iters=10, plain_ms=None):
    """Device ms (CUDA-graph replay, ``reps`` calls a graph, ``iters``
    replays) of the kernel, its plain version and the library call, and the
    kernel's ms launch by launch (host included).  With ``plain_ms`` (a plain
    version too large to repeat, timed once between events) ``plain`` is not
    run."""
    return dict(ms=_graph_ms(torch, kernel, reps, iters),
                plain_ms=_graph_ms(torch, plain, reps, iters) if plain_ms is None else plain_ms,
                library_ms=_graph_ms(torch, library, reps, iters),
                launch_ms=_time_ms(torch, kernel, iters=min(50, reps * iters),
                                   warmup=min(3, reps)))


def _bound(work):
    """Least ms for a kernel call's work (``launch/roofline.py``: its FLOPs,
    exponentials and bytes against the H100 SXM data sheet's peaks, the
    formulas the roofline also reads) and which of the two bounds it."""
    from repro_torch.launch import roofline

    s, by = roofline.bound(work)
    return s * 1e3, by


def _print_time(kernel, dtype, shape, name, t):
    """One timed kernel call's line: device ms (graph replay), the plain
    version's, the library call's, the bound and ms launch by launch."""
    hq, hkv, d = ATTN_SHAPES.get(shape, (0, 0, 0))
    heads = f", {hq}/{hkv} heads, D {d}" if hq else ""
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    print(f"time {kernel} {dtype} ({shape} {name}{heads}, {t['label']}), device (graph "
          f"replay): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa {lib}, bound "
          f"{t['bound'][0]:.5f} ms ({t['bound'][1]}, {t['ms'] / t['bound'][0]:.2f}x); kernel "
          f"launch by launch (host included) {t['launch_ms']:.4f} ms")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


# attention head shapes (Hq, Hkv, D): granite-3-2b's is the main path's (the
# kernels line); the one-period Jamba's is timed too; danube's (D 120) and
# starcoder2's (G * D = 12 x 128) are the shapes the first kernels refused;
# whisper-large-v3's (20/20, D 64) and internvl2-1b's (14/2: G 7) are the
# encoder-decoder and vision paths'; qwen2.5-14b's (G 5), qwen3-moe's (G 8,
# Hq * D = 4096 on d_model 2048) and arctic's (G 7) are served since the
# four-architecture phases, all at D 128
ATTN_SHAPES = {"granite": (32, 8, 64), "jamba": (32, 8, 128),
               "danube": (32, 8, 120), "starcoder2": (48, 4, 128),
               "whisper": (20, 20, 64), "internvl2": (14, 2, 64), "forecaster": (4, 4, 8),
               "qwen2.5": (40, 8, 128), "qwen3-moe": (32, 4, 128), "arctic": (56, 8, 128)}
FLASH_CASES = [  # (shape, name, Sq, Skv, window, causal)
    ("granite", "prefill", 512, 512, None, True), ("granite", "window128", 512, 512, 128, True),
    ("granite", "ragged", 24, 24, None, True), ("granite", "ragged_suffix", 24, 88, 16, True),
    ("jamba", "prefill", 512, 512, None, True), ("jamba", "ragged_suffix", 100, 300, 64, True),
    ("danube", "prefill", 512, 512, None, True), ("danube", "ragged_window", 77, 77, 32, True),
    ("starcoder2", "prefill", 512, 512, None, True),
    ("starcoder2", "ragged_suffix", 40, 130, 50, True),
    # whisper: the 1500-frame encoder and the cross-attention end in a 28-row
    # tile (1500 = 23 x 64 + 28); the decoder's self-attention at max_seq 448
    ("whisper", "encoder", 1500, 1500, None, False), ("whisper", "cross", 448, 1500, None, False),
    ("whisper", "decoder", 448, 448, None, True), ("internvl2", "prefill", 512, 512, None, True)]
DECODE_CASES = [  # (shape, name, S, mask: None = all valid, else (pos, window))
    ("granite", "decode", 512, None), ("granite", "window128", 512, (300, 128)),
    ("granite", "ragged", 24, (20, None)),
    ("jamba", "decode", 512, None), ("jamba", "window128", 500, (300, 128)),
    ("danube", "decode", 512, None), ("danube", "window128", 512, (300, 128)),
    ("starcoder2", "decode", 512, None), ("starcoder2", "ragged", 77, (60, None)),
    # whisper's cross cache (1500 = 46 x 32 + 28 rows, all valid) and its self
    # cache past max_seq (all valid); internvl2's G 7
    ("whisper", "cross", 1500, None), ("whisper", "self", 448, None),
    ("internvl2", "decode", 512, None), ("internvl2", "ragged", 512, (300, None))]
# the served architectures' shapes at the serves' batches (B 1 and SERVE_B):
# (shape, name, B, Sq, Skv, window, causal) and (shape, name, B, S, mask); a
# ragged mask at B > 1 ends 37 rows earlier on each next row
SERVED_SHAPES = ("qwen2.5", "starcoder2", "qwen3-moe", "arctic")
SERVE_B = 8
SERVED_FLASH_CASES = [c for shape in SERVED_SHAPES for c in (
    (shape, "prefill_b8", SERVE_B, 512, 512, None, True),
    *(((shape, "prefill", 1, 512, 512, None, True),
       (shape, "ragged_suffix", 1, 40, 130, 50, True)) if shape != "starcoder2" else ()))]
SERVED_DECODE_CASES = [c for shape in SERVED_SHAPES for c in (
    (shape, "decode_b8", SERVE_B, 512, None), (shape, "ragged_b8", SERVE_B, 512, (400, None)),
    *(((shape, "decode", 1, 512, None), (shape, "ragged", 1, 77, (60, None)))
      if shape != "starcoder2" else ()))]
# the InferenceEngines built at SERVE_B (granite at 512, whisper at 448 with
# 1500 frames, internvl2 at 512): their prefill's and decode step's shapes,
# each timed and in bf16 also held to the row gate (ROW_TOL).  Where the keys
# end in a partial tile (1500 = 23 x 64 + 28 for flash, 46 x 32 + 28 for
# decode) the row gate must refuse the kernel without that tile's keys
ENGINE_B8_FLASH = [
    ("granite", "prefill_b8", SERVE_B, 512, 512, None, True),
    ("whisper", "encoder_b8", SERVE_B, 1500, 1500, None, False),
    ("whisper", "cross_b8", SERVE_B, 448, 1500, None, False),
    ("whisper", "decoder_b8", SERVE_B, 448, 448, None, True),
    ("internvl2", "prefill_b8", SERVE_B, 512, 512, None, True)]
ENGINE_B8_DECODE = [
    ("granite", "decode_b8", SERVE_B, 512, None),
    ("whisper", "self_b8", SERVE_B, 448, None), ("whisper", "cross_b8", SERVE_B, 1500, None),
    ("internvl2", "decode_b8", SERVE_B, 512, None),
    ("internvl2", "ragged_b8", SERVE_B, 512, (400, None))]
SERVED_FLASH_CASES += ENGINE_B8_FLASH
SERVED_DECODE_CASES += ENGINE_B8_DECODE
FLASH_KEY_TILE, DECODE_KEY_TILE = 64, 32
ENGINE_B8_TIMED = {*(("flash_attention", shape, name) for shape, name, *_ in ENGINE_B8_FLASH),
                   *(("decode_attention", shape, name) for shape, name, *_ in ENGINE_B8_DECODE)}
# the bf16 cases timed: every main path's shape
TIMED = {("flash_attention", "granite", "prefill"), ("flash_attention", "jamba", "prefill"),
         ("flash_attention", "whisper", "encoder"), ("flash_attention", "whisper", "cross"),
         ("flash_attention", "whisper", "decoder"), ("flash_attention", "internvl2", "prefill"),
         ("decode_attention", "granite", "decode"), ("decode_attention", "jamba", "decode"),
         ("decode_attention", "whisper", "cross"), ("decode_attention", "whisper", "self"),
         ("decode_attention", "internvl2", "decode"),
         *((kernel, shape, name) for shape in SERVED_SHAPES
           for kernel, names in (("flash_attention", ("prefill", "prefill_b8")),
                                 ("decode_attention", ("decode", "decode_b8")))
           for name in names), *ENGINE_B8_TIMED}


def _sass_counts(name: str, ops=("HGMMA", "UTMALDG"), kernel=None):
    """Instructions ``ops`` in library ``name``'s SASS (None where cuobjdump
    is missing), over every kernel or, with ``kernel``, over the kernels
    whose mangled name matches that pattern.  HGMMA and UTMALDG: evidence that
    the bf16 kernels reached the tensor cores and TMA."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120).stdout
    if kernel is not None:
        sass = "".join(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                       if re.search(kernel, f.split("\n", 1)[0]))
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass)) for op in ops}


def _ptxas_kernels(name: str):
    """(mangled kernel name, registers, spill-store bytes) of every kernel in
    library ``name``'s ptxas report."""
    from repro_torch.kernels import _build

    log = _build.log_path(name)
    text = log.read_text() if log.exists() else ""
    out = []
    for part in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append((part.split("'", 1)[0], int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else -1))
    return out


def kernel_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import attention_mask
    from repro_torch.launch import roofline

    gen = torch.Generator(device=dev).manual_seed(0)
    timed = {}
    flash_cases = [(shape, name, 1, *rest) for shape, name, *rest in FLASH_CASES]
    decode_cases = [(shape, name, 1, *rest) for shape, name, *rest in DECODE_CASES]
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for case in flash_cases + SERVED_FLASH_CASES:
            shape, name, b, sq, skv, window, causal = case
            hq, hkv, d = ATTN_SHAPES[shape]
            q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(tdt)
            k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(tdt)
            v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(tdt)
            # causal: suffix-aligned queries (a prefill); non-causal: the
            # positions the model passes (encoder and cross: arange)
            q_pos = torch.arange(sq, device=dev, dtype=torch.int32) + (skv - sq if causal else 0)
            kv_pos = torch.arange(skv, device=dev, dtype=torch.int32)
            args = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
            got = kf.flash_attention_hopper(q, k, v, **args)
            want = kf.flash_attention_plain(q, k, v, **args)
            torch.cuda.synchronize()
            rows = case in ENGINE_B8_FLASH
            err, row, ok = _long_close(got, want, dtype, rows=rows)
            print(f"kernel flash_attention {dtype} {shape} {hq}/{hkv} D={d} {name} B={b} Sq={sq} "
                  f"Skv={skv} window={window} causal={causal}: max_abs_err={err:.3e} "
                  f"tol={KERNEL_TOL[dtype]}{_rows(row)} {'ok' if ok else 'FAIL'}")
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"flash_attention {dtype} {shape} {name} disagrees with its plain version")
            cut = skv % FLASH_KEY_TILE
            if rows and dtype == "bfloat16" and cut:
                # the kernel over every key but the last, partial tile's
                bad = kf.flash_attention_hopper(q, k[:, :-cut].contiguous(),
                                                v[:, :-cut].contiguous(),
                                                **dict(args, kv_pos=kv_pos[:-cut]))
                _gate_rejects(f"flash_attention {shape} {name} (the last {cut} keys)", dtype,
                              bad, want)
                del bad
            if dtype == "bfloat16" and ("flash_attention", shape, name) in TIMED:
                pairs = attention_mask(q_pos, kv_pos, causal=causal, window=window).sum().item()
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                timed[("flash_attention", shape, name)] = dict(
                    max_abs_err=err, label=f"B {b}, Sq {sq}, Skv {skv}, causal {causal}",
                    bound=_bound(roofline.flash_work(b, sq, skv, hq, hkv, d,
                                                     q.element_size(), pairs)),
                    **_attn_times(torch, lambda: kf.flash_attention_hopper(q, k, v, **args),
                                  lambda: kf.flash_attention_plain(q, k, v, **args),
                                  lambda: F.scaled_dot_product_attention(
                                      qt, kt, vt, is_causal=causal, enable_gqa=True)))
        for case in decode_cases + SERVED_DECODE_CASES:
            shape, name, b, s, mask_kind = case
            hq, hkv, d = ATTN_SHAPES[shape]
            q = torch.randn((b, hq, d), generator=gen, device=dev).to(tdt)
            k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(tdt)
            v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(tdt)
            idx = torch.arange(s, device=dev)
            if mask_kind is None:     # pos >= max_seq in the engine; a cross cache
                mask = torch.ones((b, s), dtype=torch.bool, device=dev)
            else:
                pos, window = mask_kind
                last = pos - 37 * torch.arange(b, device=dev)[:, None]
                mask = idx <= last
                if window is not None:
                    mask &= idx > last - window
            got = kd.decode_attention_hopper(q, k, v, mask)
            want = kd.decode_attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            rows = case in ENGINE_B8_DECODE
            err, row, ok = _long_close(got, want, dtype, rows=rows)
            print(f"kernel decode_attention {dtype} {shape} {hq}/{hkv} D={d} {name} B={b} S={s} "
                  f"splits={kd.decode_splits(b, s, hkv, kd._sms(0))}: max_abs_err={err:.3e} "
                  f"tol={KERNEL_TOL[dtype]}{_rows(row)} {'ok' if ok else 'FAIL'}")
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"decode_attention {dtype} {shape} {name} disagrees with its plain version")
            cut = s % DECODE_KEY_TILE
            if rows and dtype == "bfloat16" and cut and mask_kind is None:
                # the kernel with the last, partial tile's rows masked out
                short = mask.clone()
                short[:, -cut:] = False
                _gate_rejects(f"decode_attention {shape} {name} (the last {cut} rows)", dtype,
                              kd.decode_attention_hopper(q, k, v, short), want)
                del short
            if dtype == "bfloat16" and ("decode_attention", shape, name) in TIMED:
                n_valid = mask.sum().item()
                qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
                amask = mask[:, None, None, :]
                timed[("decode_attention", shape, name)] = dict(
                    max_abs_err=err, label=f"B {b}, S {s}, {n_valid} valid",
                    bound=_bound(roofline.decode_work(b, s, hq, hkv, d, k.element_size(),
                                                      n_valid)),
                    **_attn_times(torch, lambda: kd.decode_attention_hopper(q, k, v, mask),
                                  lambda: kd.decode_attention_plain(q, k, v, mask),
                                  lambda: F.scaled_dot_product_attention(
                                      qt, kt, vt, attn_mask=amask, enable_gqa=True)))
    for (kernel, shape, name), t in timed.items():
        _print_time(kernel, "bfloat16", shape, name, t)
    for shape, b, s in (("granite", 1, MAX_SEQ), ("whisper", 1, 1500), ("internvl2", 1, MAX_SEQ),
                        *((shape, b, MAX_SEQ) for shape in SERVED_SHAPES for b in (1, SERVE_B)),
                        ("granite", SERVE_B, MAX_SEQ), ("whisper", SERVE_B, 1500),
                        ("whisper", SERVE_B, ENCDEC_SEQ), ("internvl2", SERVE_B, MAX_SEQ)):
        hq, hkv, d = ATTN_SHAPES[shape]
        splits = kd.decode_splits(b, s, hkv, kd._sms(0))
        print(f"decode_attention splits at {shape}'s decode (B {b}, S {s}, {hkv} kv heads, G "
              f"{hq // hkv}, D {d}): {splits} -> {splits * b * hkv} blocks on {kd._sms(0)} SMs, "
              f"{kd.split_smem_bytes(hq // hkv, d)} B shared a block")
    return timed


def _ssm_inputs(torch, gen, bt, t, din, n, dtype):
    """u, B, C in ``dtype``; delta, A, D and a nonzero h0 in fp32 (the Mamba
    mixer's types)."""
    dev, tdt = gen.device, getattr(torch, dtype)
    u = torch.randn((bt, t, din), generator=gen, device=dev).to(tdt)
    delta = torch.rand((bt, t, din), generator=gen, device=dev) * 0.1
    A = -(torch.rand((din, n), generator=gen, device=dev) + 0.5)
    B = torch.randn((bt, t, n), generator=gen, device=dev).to(tdt)
    C = torch.randn((bt, t, n), generator=gen, device=dev).to(tdt)
    D = torch.randn((din,), generator=gen, device=dev)
    h0 = torch.randn((bt, din, n), generator=gen, device=dev)
    return u, delta, A, B, C, D, h0


def ssm_kernel_phase(torch, dev):
    """The selective scan against its plain version: ragged fixtures, then the
    one-period Jamba prefill shape (Bt 1, T 512, Din 8192, N 16), timed."""
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.launch import roofline

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(2, t, din, n) for t in (1, 37, 256, 300) for din in (64, 200)
             for n in (4, 8, 16)] + [(1, MAX_SEQ, 8192, 16)]
    worst, timed = {}, None
    for dtype in ("float32", "bfloat16"):
        for case in cases:
            args = _ssm_inputs(torch, gen, *case, dtype)
            got = ks.ssm_scan_hopper(*args)
            want = ks.ssm_scan_plain(*args)
            torch.cuda.synchronize()
            errs = [_close(g, w, SSM_TOL[dtype]) for g, w in zip(got, want)]
            err, ok = max(e for e, _ in errs), all(o for _, o in errs)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            if not ok or not all(torch.isfinite(g.float()).all() for g in got):
                _fail(f"ssm_scan {dtype} Bt,T,Din,N={case} disagrees with its plain version "
                      f"(max_abs_err {err:.3e}, tol {SSM_TOL[dtype]})")
            if case[2] != 8192:
                continue
            print(f"kernel ssm_scan {dtype} jamba Bt,T,Din,N={case}: y, hT max_abs_err="
                  f"{err:.3e} tol={SSM_TOL[dtype]} ok")
            bt, t, din, n = case
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            ks.ssm_scan_plain(*args)
            stop.record()
            torch.cuda.synchronize()
            geo = ks.scan_geometry(n, args[0].element_size())
            row = dict(max_abs_err=err,
                       ms=_graph_ms(torch, lambda: ks.ssm_scan_hopper(*args)),
                       launch_ms=_time_ms(torch, lambda: ks.ssm_scan_hopper(*args)),
                       plain_ms=start.elapsed_time(stop), library_ms=None,
                       bound=_bound(roofline.ssm_scan_work(bt, t, din, n,
                                                           args[0].element_size())))
            print(f"time ssm_scan {dtype} (jamba shape; {geo['lanes']} lanes x "
                  f"{geo['states']} states a channel, {geo['threads']} threads, "
                  f"{geo['smem_bytes']} B shared a block): kernel {row['ms']:.4f} ms device "
                  f"(graph replay), {row['launch_ms']:.4f} ms launch by launch (host "
                  f"included); plain {row['plain_ms']:.4f} ms (one call), library none, "
                  f"bound {row['bound'][0]:.5f} ms ({row['bound'][1]})")
            if dtype == "bfloat16":
                timed = row
    print(f"kernel ssm_scan: {2 * len(cases)} cases ok (Bt 2, T 1-300, Din 64/200, N 4-16, "
          f"and the jamba shape), max_abs_err fp32 {worst['float32']:.3e}, "
          f"bf16 {worst['bfloat16']:.3e}")
    return timed


# --------------------------------------------------------------------------- #
# phase 4: full-width fp32 model, kernel path vs plain path
# --------------------------------------------------------------------------- #


def model_phase(torch, dev, cfg, label, *, max_seq=MAX_SEQ, prompt=MODEL_PROMPT,
                extras=None, batches=(1,)):
    """Prefill of a ``prompt``-token prompt + 4 decode steps through the hand
    kernels and through the plain oracles on one set of fp32 weights, at
    each batch of ``batches`` (B different prompts in one call).
    ``extras(gen)`` gives the prefill's other inputs (frames, image embeds).
    Returns the weights' bytes and the peak allocated during their init."""
    from repro_torch.models import registry

    t0 = time.perf_counter()
    kernel = registry.build(cfg, max_seq=max_seq, device=dev)
    plain = registry.build(dataclasses.replace(cfg, attention_impl="oracle"),
                           max_seq=max_seq, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = kernel.init(gen)
    torch.cuda.synchronize()
    init = dict(weights=sum(t.numel() * t.element_size() for t in model.state_dict().values()),
                peak=torch.cuda.max_memory_allocated() - before)
    print(f"model {label}: {sum(t.numel() for t in model.state_dict().values()) / 1e9:.3f} B "
          f"parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; init "
          f"{time.perf_counter() - t0:.2f} s, its peak {init['peak'] / 1e9:.2f} GB for "
          f"{init['weights'] / 1e9:.2f} GB of weights")
    for b in batches:
        at_b = f" B {b}" if batches != (1,) else ""
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen, device=dev)
        batch = {"tokens": tokens, **(extras(gen) if extras else {})}
        with torch.inference_mode():
            lk, ck, pos = kernel.prefill(model, batch)
            lp, cp, _ = plain.prefill(model, batch)
            steps = [("prefill", lk, lp)]
            for i in range(4):
                tok = lk.argmax(-1)
                lk, ck = kernel.decode_step(model, ck, tok, pos + i)
                lp, cp = plain.decode_step(model, cp, tok, pos + i)
                steps.append((f"decode{i}", lk, lp))
            for name, a, want in steps:
                if a.shape != (b, cfg.vocab_size) or not torch.isfinite(a).all():
                    _fail(f"model {label}{at_b} {name} logits: shape {tuple(a.shape)} or not "
                          f"finite")
                err, ok = _close(a, want, MODEL_TOL)
                print(f"model {label}{at_b} {name}: max |logit err| {err:.3e} (logit scale "
                      f"{want.abs().max().item():.3f}) tol={MODEL_TOL} {'ok' if ok else 'FAIL'}")
                if not ok:
                    _fail(f"full-width {label}{at_b} {name}: kernel path disagrees with plain "
                          f"path")
        del ck, cp
    print(f"model {label}: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    del model
    _free(torch)
    return init


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 5: the bf16 full-width engine
# --------------------------------------------------------------------------- #


def engine_phase(torch, arch=ARCH, *, max_seq=MAX_SEQ, launches=None, extras=None,
                 zero_tail=False, designs=True, batched=False, restore_gate=True, batch=1):
    """The bf16 full-width InferenceEngine built for ``batch`` rows: cold
    start, REQUESTS requests (``batch`` different prompts each), scale to
    zero, snapshot restore, 1 request (the first's tokens), with exact launch
    counts; ``launches`` is (flash a prefill, decode a decode step), one
    attention layer's each by default.  ``extras(rng)`` draws a request's
    other inputs; ``zero_tail``: every token after the first is 0 (whisper's
    decode past its position table: its token gates then cover the prefill's
    token alone).  At ``batch`` > 1 the first request's prefill logits are
    finite and not equal in every row (``_prefill_logits``), its tokens
    equal ``engine.generate``'s on the engine's bundle and weights, and its
    rows are not all equal.  With ``batched``, one
    SERVE_B-row request through the engine's loop on its bundle and weights
    (counted apart, under ``"b8"``).  Then the restore designs (granite) or
    the restore gate (without ``restore_gate``, the comparison printed only),
    and one traced request."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.core.lifecycle import Phase
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore, generate

    cfg = get_config(arch)
    vocab = cfg.vocab_size
    per_prefill, per_step = launches or (cfg.num_layers, cfg.num_layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (batch, max_seq)).astype(np.int32)
               for _ in range(REQUESTS)]
    inputs = [extras(rng) if extras else None for _ in range(REQUESTS)]

    def counts():
        return kf.launches, kd.launches

    def expect(what, before, flash, decode):
        got = tuple(a - b for a, b in zip(counts(), before))
        print(f"launches during {what}: flash_attention {got[0]}, decode_attention {got[1]} "
              f"(expected {flash}, {decode})")
        if got != (flash, decode):
            _fail(f"{arch} launch counts during {what}: {got} != {(flash, decode)}")

    def serve(i):
        return eng.serve(prompts[i], decode_steps=DECODE_STEPS, extras=inputs[i])

    with tempfile.TemporaryDirectory() as snapdir:
        eng = InferenceEngine(arch, smoke=False, max_seq=max_seq, batch=batch,
                              store=SnapshotStore(snapdir), device="cuda")
        kf.launches = kd.launches = 0               # the main path starts here
        c = counts()
        bd = eng.cold_start()
        print(f"engine {arch} cold_start: {bd}, weights {eng.package_bytes() / 1e9:.3f} GB bf16")
        expect("cold_start (warm-up)", c, per_prefill, per_step)
        outs, prefills = [], []
        for i in range(REQUESTS):
            c = counts()
            out, st = serve(i)
            prefills.append(st.prefill_s)
            at_b, rows = "", ""
            if batch > 1:
                at_b = f" B {batch}"
                rows = (f", {st.decode_s / st.tokens / batch * 1e3:.3f} ms a row's token, "
                        f"{len(set(map(tuple, out.tolist())))} distinct rows")
            print(f"engine {arch}{at_b} serve {i}: prefill {st.prefill_s * 1e3:.2f} ms, decode "
                  f"{st.decode_s * 1e3:.2f} ms for {st.tokens} tokens "
                  f"({st.decode_s / st.tokens * 1e3:.3f} ms/token{rows}), tokens "
                  f"{out[0].tolist()}")
            expect(f"serve {i}", c, per_prefill, per_step * DECODE_STEPS)
            if out.shape != (batch, DECODE_STEPS) or not ((out >= 0) & (out < vocab)).all():
                _fail(f"{arch} serve {i} tokens out of range: {out}")
            if zero_tail and (out[:, 1:] != 0).any():
                _fail(f"{arch} serve {i}: tokens after the first {out[:, 1:]} are not all 0")
            outs.append(out)
        if zero_tail:
            print(f"engine {arch}: every token after the first is 0 (decodes at max_seq + i "
                  f"read NaN past the {max_seq}-row position table, as jnp.take fills)")
        eng.shutdown()
        c = counts()
        bd2 = eng.cold_start(from_snapshot=True)
        print(f"engine {arch} restore: {bd2}")
        expect("restore (warm key: no warm-up)", c, 0, 0)
        c = counts()
        out, st = serve(0)
        print(f"engine {arch} serve after restore: prefill {st.prefill_s * 1e3:.2f} ms, decode "
              f"{st.decode_s * 1e3:.2f} ms, tokens {out[0].tolist()}")
        expect("serve after restore", c, per_prefill, per_step * DECODE_STEPS)
        if not np.array_equal(out, outs[0]):
            _fail(f"{arch} tokens after restore {out} != first request's {outs[0]}")
        total = counts()                              # read just after the main path
        n_serves = REQUESTS + 1
        want = (per_prefill * (1 + n_serves), per_step * (1 + n_serves * DECODE_STEPS))
        print(f"launches over the {arch} engine run: flash_attention {total[0]} "
              f"({per_prefill}/prefill), decode_attention {total[1]} ({per_step}/decode step)")
        if total != want:
            _fail(f"{arch} engine run launches {total} != {want}")
        if batch > 1:
            _prefill_logits(torch, eng.bundle, eng.params, prompts[0], inputs[0],
                            f"engine {arch} B {batch}")
            loop, _ = generate(eng.bundle, eng.params, prompts[0], decode_steps=DECODE_STEPS,
                               extras=inputs[0])
            distinct = len(set(map(tuple, outs[0].tolist())))
            print(f"engine {arch} B {batch}: served tokens equal engine.generate's on its bundle "
                  f"and weights {np.array_equal(loop, outs[0])}; {distinct} distinct rows of "
                  f"{batch}")
            if not np.array_equal(loop, outs[0]):
                _fail(f"{arch} B {batch}: served tokens {outs[0]} != generate's {loop}")
            if distinct == 1:
                _fail(f"{arch} B {batch}: every row's tokens are equal ({outs[0][0]})")
        b8 = None
        if batched:
            wide = rng.integers(0, vocab, (SERVE_B, max_seq))
            b8 = serve_request(torch, eng.bundle, eng.params, wide, f"engine {arch} B {SERVE_B}",
                               (0, per_prefill, per_step * DECODE_STEPS))
            check_logits(torch, eng.bundle, eng.params, wide, f"{arch} B {SERVE_B}")
        if designs:
            restore_designs(eng, bd, bd2, prompts[0], outs[0])
        else:
            dl = bd2.seconds.get(Phase.DEPS_LOAD, 0.0)
            size = eng.package_bytes()
            source = "pinned host copy" if eng.key in eng.store.host else "file"
            print(f"engine {arch} restore from the {source}: deps_load {dl * 1e3:.2f} ms for "
                  f"{size / 1e9:.3f} GB = {size / 1e9 / dl:.2f} GB/s")
            if restore_gate:
                _gate_restore(f"{arch} full width", bd, bd2)
            else:
                print(f"C2 {arch} full width, measured, not gated: restore total "
                      f"{bd2.total * 1e3:.2f} ms vs cold start total {bd.total * 1e3:.2f} ms "
                      f"(deps_load {bd.seconds.get(Phase.DEPS_LOAD, 0.0) * 1e3:.2f} ms drawing "
                      f"the weights on the card, code_init "
                      f"{bd.seconds.get(Phase.CODE_INIT, 0.0) * 1e3:.2f} ms)")
        profile = profile_serve(torch, lambda: _wall(serve(1)[1]),
                                check=arch == ARCH and batch > 1)
    return {"flash_attention": total[0], "decode_attention": total[1],
            "prefill_s": min(prefills), "b8": b8, "profile": profile}


def _prefill_logits(torch, bundle, params, tokens, extras, label):
    """One prefill of ``tokens`` (and ``extras``) on ``bundle`` and
    ``params``, its inputs made as the engine's loop makes them: the (B,
    vocab) last logits in fp32, which must be finite and not equal in every
    row (outside any counted run)."""
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(bundle.device)}
        batch.update({k: torch.as_tensor(v).to(bundle.device) for k, v in (extras or {}).items()})
        logits = bundle.prefill(params, batch)[0].float()
    finite = bool(torch.isfinite(logits).all())
    differ = bool((logits[1:] != logits[:1]).any())
    print(f"{label}: prefill logits {tuple(logits.shape)} finite {finite}, rows not all equal "
          f"{differ}")
    if not (finite and differ):
        _fail(f"{label}: prefill logits not finite, or equal in every row")
    return logits


def _gate_restore(label, cold, restore):
    """C2: a snapshot restore must cost less than a cold start."""
    print(f"C2 {label}: restore total {restore.total * 1e3:.2f} ms vs cold start total "
          f"{cold.total * 1e3:.2f} ms ({'ok' if restore.total < cold.total else 'FAIL'})")
    if not restore.total < cold.total:
        _fail(f"{label}: snapshot restore {restore} is not cheaper than cold start {cold}")


def restore_designs(eng, cold, pinned, prompt, want):
    """The two restore designs on one snapshot: (b) the store's pinned host
    copy (the engine's restore above) and (a) the file alone, memory-mapped
    and copied to the card (a store with no host copy, as a new process has;
    the file is in the page cache, as on a node that wrote it).  The
    warmed-key cache is shared, so only deps_load differs."""
    import numpy as np
    from repro_torch.core.lifecycle import Phase
    from repro_torch.serving.engine import SnapshotStore

    store = eng.store
    fresh = SnapshotStore(store.root)
    fresh.executables = store.executables
    size = Path(store._path(eng.key)).stat().st_size
    eng.shutdown()
    eng.store = fresh
    file_bd = eng.cold_start(from_snapshot=True)
    eng.store = store
    out, _ = eng.serve(prompt, decode_steps=DECODE_STEPS)
    if not np.array_equal(out, want):
        _fail(f"tokens after the file restore {out} != first request's {want}")
    for label, bd in (("(a) file, mmap + copy", file_bd), ("(b) pinned host copy", pinned)):
        dl = bd.seconds.get(Phase.DEPS_LOAD, 0.0)
        print(f"restore design {label}: {bd}; deps_load {dl * 1e3:.2f} ms for "
              f"{size / 1e9:.3f} GB = {size / 1e9 / dl:.2f} GB/s")
    _gate_restore(f"{eng.arch} full width (pinned restore)", cold, pinned)


def _wall(stats) -> float:
    return stats.prefill_s + stats.decode_s


def _device_spans(prof):
    """(name, start us, end us) of each device activity in a finished
    torch.profiler trace, read from the profiler's raw results: building its
    FunctionEvents (``prof.events()``) takes about a minute at the ~10^6
    events of one xlstm-125m train step.  Times count from the trace's start,
    as the FunctionEvents' do: nanoseconds since the epoch (~1.8e18) in
    microseconds as a double keep only a quarter of a microsecond."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    return [(e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)
            for e in results.events() if e.device_type() == DeviceType.CUDA]


def _busy_us(spans) -> float:
    """Microseconds in which the device ran at least one of ``spans`` (the
    union of their intervals): a kernel launched to wait on the one before it
    (the decode kernel's combine) overlaps it, and summing their durations
    would count that stretch twice."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda span: span[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _check_spans(prof, spans):
    """``_device_spans`` against the profiler's FunctionEvents of the same
    trace (``prof.events()``, device events only): the same count and the same
    union of intervals (their clocks differ by the trace's start)."""
    from torch.autograd import DeviceType

    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    raw, old = _busy_us(spans), _busy_us(events)
    same = len(events) == len(spans) and abs(raw - old) <= 1e-6 * old + 1e-3
    print(f"profile spans: the raw results' {len(spans)} device spans, busy {raw:.3f} us; the "
          f"FunctionEvents' {len(events)}, busy {old:.3f} us: the same {same}")
    if not same:
        _fail("the profiler's raw device spans differ from its FunctionEvents")


def profile_serve(torch, serve, check=False):
    """Device busy share and kernel time by name over one warm request: the
    wall time from an unprofiled request, the kernel time from a traced one
    (device activity only: an xLSTM request launches ~10^5 eager ops).
    ``serve()`` runs one request and returns its wall seconds; with
    ``check``, the trace's spans are also read through ``_check_spans``."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    wall_us = serve() * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve()
    spans = _device_spans(prof)
    if check:
        _check_spans(prof, spans)
    by_name = defaultdict(lambda: [0.0, 0])
    for name, a, b in spans:
        by_name[name][0] += b - a
        by_name[name][1] += 1
    busy = _busy_us(spans)
    if busy == 0:
        print("profile: no device time recorded (not measured)")
        return None
    print(f"profile one serve: wall {wall_us / 1e3:.2f} ms (unprofiled), device busy "
          f"{busy / 1e3:.2f} ms (kernel times summed {sum(v[0] for v in by_name.values()) / 1e3:.2f}"
          f" ms), idle share {1 - busy / wall_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile   {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    return dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3, idle=1 - busy / wall_us)


# --------------------------------------------------------------------------- #
# the hybrid family: one full-width Jamba period
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def router_gaps(torch, cfg, label):
    """Track the smallest gap between the k-th and (k+1)-th router
    probability that any MoE dispatch meets inside the block, and print it:
    a gap near two paths' ~1e-6 difference could route them apart without a
    kernel fault.  Also track the largest expert load against its group's
    capacity (a load past it drops tokens); yields {"gap", "load", "cap"}."""
    from repro_torch.models import moe

    dispatch = moe._dispatch_group
    seen = {"gap": float("inf"), "load": 0, "cap": 0}

    def tracked(x, p, c):
        k = c.moe.top_k
        probs = torch.softmax(x.float() @ p.router, dim=-1)
        top = probs.topk(k + 1, dim=-1)
        seen["gap"] = min(seen["gap"], (top.values[:, -2] - top.values[:, -1]).min().item())
        load = int(torch.bincount(top.indices[:, :k].flatten(),
                                  minlength=c.moe.num_experts).max())
        cap = moe._capacity(x.shape[0], c.moe)
        if load * seen["cap"] >= seen["load"] * cap:         # the fullest expert yet
            seen["load"], seen["cap"] = load, cap
        return dispatch(x, p, c)

    moe._dispatch_group = tracked
    try:
        yield seen
    finally:
        moe._dispatch_group = dispatch
        print(f"model {label} fp32: smallest top-{cfg.moe.top_k} / top-{cfg.moe.top_k + 1} "
              f"router probability gap met {seen['gap']:.3e}; largest expert load against its "
              f"group's capacity {seen['load']} / {seen['cap']}")


def hybrid_model_phase(torch, dev):
    """Phase 4 on the one-period Jamba in fp32, with the smallest router gap
    met on either path."""
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_LAYERS,
                              dtype="float32", param_dtype="float32")
    with router_gaps(torch, cfg, HYBRID):
        model_phase(torch, dev, cfg, f"{HYBRID} x{HYBRID_LAYERS} layers fp32")


def hybrid_serve_phase(torch, dev):
    """The one-period Jamba in bf16 through ``arch_serve_phase`` at B 1 only:
    the scan's launches over its requests."""
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_LAYERS)
    launches, _ = arch_serve_phase(torch, dev, cfg, f"{HYBRID} x{HYBRID_LAYERS}", wide=False)
    return launches[1][0]


def hybrid_engine_phase(torch):
    """InferenceEngine on jamba SMOKE (2 layers AM; SMOKE size, not a
    measurement): cold start, serve, scale to zero, snapshot restore, serve."""
    import numpy as np
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore

    def counts():
        return ks.launches, kf.launches, kd.launches

    with tempfile.TemporaryDirectory() as snapdir:
        eng = InferenceEngine(HYBRID, smoke=True, store=SnapshotStore(snapdir), device="cuda")
        prompt = np.random.default_rng(1).integers(0, 512, (1, eng.max_seq))
        c = counts()
        bd = eng.cold_start()
        warm = tuple(a - b for a, b in zip(counts(), c))
        print(f"hybrid SMOKE engine cold_start: {bd}; launches in the warm-up (ssm_scan, "
              f"flash_attention, decode_attention) {warm}")
        if warm != (1, 1, 1):
            _fail(f"hybrid SMOKE warm-up launches {warm} != (1, 1, 1)")
        first, _ = eng.serve(prompt, decode_steps=DECODE_STEPS)
        eng.shutdown()
        bd2 = eng.cold_start(from_snapshot=True)
        again, _ = eng.serve(prompt, decode_steps=DECODE_STEPS)
        print(f"hybrid SMOKE engine restore: {bd2}; tokens {first[0].tolist()} then "
              f"{again[0].tolist()}")
        if not np.array_equal(first, again):
            _fail(f"hybrid SMOKE tokens after restore {again} != {first}")


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


def _cluster_bound(args, outs, t_begin: int = 0):
    """Least time for one launch on this run's inputs, over its active steps
    (those inside each cell's horizon; the launch's steps start at step
    ``t_begin``): every input read once and every output written once,
    except ``conc``, which the kernel reads only in active steps; against
    the operations of the active steps, counted from the kernel's arithmetic
    (about 70 per function and 22 per (function, worker) pair in a step
    whose expiry walk stops at its first edge)."""
    import math

    from repro_torch.kernels import ref as R
    from repro_torch.launch import roofline

    nw, arrivals, conc, scal = args[0], args[3], args[4], args[10]
    _, f, w = nw.shape
    t_steps = arrivals.shape[1]
    active = sum(min(t_steps, max(0, math.ceil(float(h) / float(dt)) - t_begin))
                 for h, dt in scal[:, [R.SC_HORIZON, R.SC_DT]].tolist())
    nbytes = (_nbytes(*(a for a in args if a is not conc), *outs)
              + active * f * conc.element_size())
    return _bound(roofline.Work(active * f * (70 + 22 * w), 0.0, nbytes, "float32"))


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
    k = args[7].shape[2]
    print(f"cluster {name} C={c} F={f} W={w} K={k} T={args[3].shape[1]} "
          f"layout={kc.layout(f, w, k)}: max_abs_err={err:.3e} rtol={CLUSTER_TOL['rtol']} "
          f"atol={CLUSTER_TOL['atol']} {'ok' if ok else 'FAIL'}")
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
        kc.layout_launches.update(warp=0, block=0)
        t0 = time.perf_counter()
        rows = list(runner.run_sweep(grid, driver="batch"))
        wall = time.perf_counter() - t0
        n = kc.launches                             # read just after the main path
        by_layout = dict(kc.layout_launches)
        launches += n
        cells = registry.get_sweep(grid).scenarios()
        print(f"batch {grid}: {len(rows)} cells in {wall:.3f} s (run_sweep, driver=batch), "
              f"cluster_step launches {n} by layout {by_layout}")
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
        kernel_ms = _graph_ms(torch, lambda: kc.cluster_sim_hopper(*args), reps=2, iters=5)
        launch_ms = _time_ms(torch, lambda: kc.cluster_sim_hopper(*args), iters=10)
        bound = _cluster_bound(args, got)
        kind = kc.layout(*args[0].shape[1:], args[7].shape[2])
        print(f"time cluster_step fp32 ({grid}, layout {kind}): "
              f"kernel {kernel_ms:.4f} ms device (graph replay), {launch_ms:.4f} ms launch by "
              f"launch (host included); plain {plain_ms:.4f} ms (one call), library none, "
              f"bound {bound[0]:.5f} ms ({bound[1]})")
        if grid == "batch_dense64":
            timed = dict(max_abs_err=err, ms=kernel_ms, launch_ms=launch_ms, plain_ms=plain_ms,
                         library_ms=None, bound=bound)
        t0 = time.perf_counter()
        batchsim.simulate_batch(cells, trace_fn=runner.build_trace)
        sim_s = time.perf_counter() - t0
        invocations = sum(tables.invocations)
        print(f"batch {grid}: build_tables {build_s:.3f} s (traces cached), kernel "
              f"{kernel_ms:.4f} ms, simulate_batch wall {sim_s:.3f} s, {invocations} "
              f"invocations, {invocations / sim_s:.1f} invocations/s")
        _profile_call(torch, sim_s,
                      lambda: batchsim.simulate_batch(cells, trace_fn=runner.build_trace),
                      "batch call")
    _spot_check(torch)
    return launches, timed


def _profile_call(torch, wall_s, call, label, top=4, also=()):
    """Device busy share of one ``call()``: the device time from a traced call
    over the wall time of an unprofiled one (the first trace also pays the
    profiler's start-up); the device activities, the top kernels and every
    kernel whose name holds one of ``also``, with its launches.  Returns the
    busy share (None where no device time was recorded)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host's ops would only slow the trace's processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    count = defaultdict(int)
    device = _device_spans(prof)
    for name, a, b in device:
        by_name[name] += b - a
        count[name] += 1
    busy = _busy_us(device)
    if busy == 0:
        print(f"profile {label}: no device time recorded (not measured)")
        return
    print(f"profile {label}: wall {wall_s * 1e3:.2f} ms (unprofiled), device busy "
          f"{busy / 1e3:.3f} ms (kernel times summed {sum(by_name.values()) / 1e3:.3f} ms), "
          f"busy share {busy / (wall_s * 1e6):.5f}, {len(device)} device activities")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile   {us / 1e3:9.3f} ms  {name[:90]}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if any(part in name for part in also):
            print(f"profile   {us / 1e3:9.3f} ms  x{count[name]}  {name[:90]}")
    return busy / (wall_s * 1e6)


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

# --------------------------------------------------------------------------- #
# phase 8: the xLSTM family at full width
# --------------------------------------------------------------------------- #


def _device_launches(torch, fn) -> int:
    """Device activities (kernels, copies, fills) recorded by torch.profiler
    over one ``fn()``: the host's launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(_device_spans(prof))


def xlstm_model_phase(torch, dev):
    """xlstm-125m at full width cut to XLSTM_CHECK_LAYERS layers, in fp32: a
    MAX_SEQ-token prefill and 4 decode steps on the card against the same
    weights on the CPU."""
    from repro_torch.config import get_config
    from repro_torch.models import registry

    cfg = dataclasses.replace(get_config(XLSTM), num_layers=XLSTM_CHECK_LAYERS,
                              dtype="float32", param_dtype="float32")
    card = registry.build(cfg, max_seq=MAX_SEQ, device=dev)
    host = registry.build(cfg, max_seq=MAX_SEQ, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = card.init(gen)
    ref = host.empty()
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    n = sum(t.numel() for t in model.state_dict().values())
    print(f"xlstm {XLSTM} fp32: {n / 1e6:.2f} M parameters (layers "
          f"{cfg.layer_pattern}), {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    tokens = torch.randint(0, cfg.vocab_size, (1, MAX_SEQ), generator=gen, device=dev)
    with torch.inference_mode():
        lk, ck, pos = card.prefill(model, {"tokens": tokens})
        t0 = time.perf_counter()
        card.prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        lp, cp, _ = host.prefill(ref, {"tokens": tokens.cpu()})
        cpu_s = time.perf_counter() - t0
        steps = [("prefill", lk, lp)]
        for i in range(4):
            tok = lk.argmax(-1)
            lk, ck = card.decode_step(model, ck, tok, pos + i)
            lp, cp = host.decode_step(ref, cp, tok.cpu(), pos + i)
            steps.append((f"decode{i}", lk, lp))
        for name, a, b in steps:
            a = a.cpu()
            if a.shape != (1, cfg.vocab_size) or not torch.isfinite(a).all():
                _fail(f"xlstm {name} logits: shape {tuple(a.shape)} or not finite")
            err, ok = _close(a, b, MODEL_TOL)
            print(f"xlstm fp32 {name}: card vs CPU max |logit err| {err:.3e} (logit scale "
                  f"{b.abs().max().item():.3f}) tol={MODEL_TOL} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"full-width {XLSTM} {name}: the card disagrees with the CPU")
        short = tokens[:, :32]
        per_prefill = _device_launches(torch, lambda: card.prefill(model, {"tokens": short}))
        per_step = _device_launches(torch, lambda: card.decode_step(model, ck, tok, pos))
    print(f"xlstm fp32 prefill of {MAX_SEQ} tokens: {prefill_ms:.1f} ms on the card "
          f"({prefill_ms / MAX_SEQ:.3f} ms/token), {cpu_s:.2f} s on the host's CPU; "
          f"device launches {per_prefill / short.shape[1]:.1f} per prefill token "
          f"(32-token prefill), {per_step} per decode step")
    del model, ref, ck, cp
    _free(torch)


def xlstm_engine_phase(torch):
    """The bf16 full-width engine on xlstm-125m: cold start, 3 requests,
    scale to zero, snapshot restore, 1 request; one traced request."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore

    vocab = get_config(XLSTM).vocab_size
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, vocab, (1, MAX_SEQ)).astype(np.int32) for _ in range(REQUESTS)]
    with tempfile.TemporaryDirectory() as snapdir:
        eng = InferenceEngine(XLSTM, smoke=False, max_seq=MAX_SEQ, batch=1,
                              store=SnapshotStore(snapdir), device="cuda")
        bd = eng.cold_start()
        print(f"xlstm engine cold_start: {bd}, weights {eng.package_bytes() / 1e9:.3f} GB")
        outs = []
        for i, p in enumerate(prompts):
            out, st = eng.serve(p, decode_steps=DECODE_STEPS)
            print(f"xlstm engine serve {i}: prefill {st.prefill_s * 1e3:.2f} ms, decode "
                  f"{st.decode_s * 1e3:.2f} ms for {st.tokens} tokens "
                  f"({st.decode_s / st.tokens * 1e3:.3f} ms/token), tokens {out[0].tolist()}")
            if out.shape != (1, DECODE_STEPS) or not ((out >= 0) & (out < vocab)).all():
                _fail(f"xlstm serve {i} tokens out of range: {out}")
            outs.append(out)
        eng.shutdown()
        bd2 = eng.cold_start(from_snapshot=True)
        print(f"xlstm engine restore: {bd2}")
        out, st = eng.serve(prompts[0], decode_steps=DECODE_STEPS)
        print(f"xlstm engine serve after restore: prefill {st.prefill_s * 1e3:.2f} ms, "
              f"decode {st.decode_s * 1e3:.2f} ms, tokens {out[0].tolist()}")
        if not np.array_equal(out, outs[0]):
            _fail(f"xlstm tokens after restore {out} != first request's {outs[0]}")
        _gate_restore(f"{XLSTM} full width", bd, bd2)
        profile_serve(torch, lambda: _wall(eng.serve(prompts[1], decode_steps=DECODE_STEPS)[1]))
        eng.shutdown()
    _free(torch)


# --------------------------------------------------------------------------- #
# phase 9: the router / fleet facade at full width
# --------------------------------------------------------------------------- #


def facade_phase(torch):
    """Two functions behind one ServerlessRouter (the reference's API, the
    EngineProfile set after register): each COLD then warm at ttl 300; then a
    ttl-0 router on the same store, whose requests restore."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.core.metrics import format_summary
    from repro_torch.fleet.pool import EngineProfile
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serving.engine import SnapshotStore
    from repro_torch.serving.router import FunctionDef, ServerlessRouter

    functions = {"xlstm": XLSTM, "granite": ARCH}
    layers = {name: (get_config(arch).num_layers if arch == ARCH else 0)
              for name, arch in functions.items()}

    def router_for(ttl, store):
        router = ServerlessRouter(ttl_s=ttl, store=store)
        for name, arch in functions.items():
            router.register(FunctionDef(name, arch, max_seq=MAX_SEQ, decode_steps=DECODE_STEPS))
            router.backend.profiles[name] = EngineProfile(
                arch=arch, max_seq=MAX_SEQ, decode_steps=DECODE_STEPS, smoke=False)
        return router

    rng = np.random.default_rng(3)
    tokens = {name: rng.integers(0, get_config(arch).vocab_size, (1, MAX_SEQ)).astype(np.int32)
              for name, arch in functions.items()}

    def invoke(router, name, what, warm_ups):
        c = (kf.launches, kd.launches)
        out, rec = router.invoke(name, tokens[name])
        got = (kf.launches - c[0], kd.launches - c[1])
        n = layers[name]
        want = (n * (1 + warm_ups), n * (DECODE_STEPS + warm_ups))
        print(f"facade {name} {what}: {'COLD' if rec.cold else 'warm'} latency "
              f"{rec.latency * 1e3:.2f} ms startup {rec.startup}; launches flash_attention, "
              f"decode_attention {got} (expected {want})")
        if got != want:
            _fail(f"facade {name} {what}: launch counts {got} != {want}")
        return out, rec

    with tempfile.TemporaryDirectory() as snapdir:
        store = SnapshotStore(snapdir)
        router = router_for(300.0, store)
        kf.launches = kd.launches = 0                 # the facade's path starts here
        cold = {}
        for name in functions:
            out_c, rc = invoke(router, name, "first", warm_ups=1)
            out_w, rw = invoke(router, name, "second", warm_ups=0)
            if not (rc.cold and not rw.cold and rw.latency < rc.latency):
                _fail(f"facade {name}: expected COLD then a faster warm request, got "
                      f"{rc.cold}/{rc.latency:.4f} s then {rw.cold}/{rw.latency:.4f} s")
            if not np.array_equal(out_c, out_w):
                _fail(f"facade {name}: warm tokens {out_w} != cold tokens {out_c}")
            cold[name] = (rc.startup, out_c)
        print(format_summary("facade ttl=300", router.summary()))
        zero = router_for(0.0, store)
        for name in functions:
            for i in range(2):
                out, rec = invoke(zero, name, f"ttl0 request {i}", warm_ups=0)
                if not rec.cold or not np.array_equal(out, cold[name][1]):
                    _fail(f"facade {name} ttl 0 request {i}: cold={rec.cold}, tokens {out}")
                _gate_restore(f"facade {functions[name]} ttl 0 request {i}",
                              cold[name][0], rec.startup)
        total = (kf.launches, kd.launches)            # read just after the facade's path
        print(format_summary("facade ttl=0", zero.summary()))
        print(f"facade launches: flash_attention {total[0]}, decode_attention {total[1]}")
        if min(total) == 0:
            _fail(f"a kernel of the facade's path was never launched: {total}")
    _free(torch)


# --------------------------------------------------------------------------- #
# phase 10: the serve launcher; phase 11: the engine driver and calibration
# --------------------------------------------------------------------------- #


def launcher_phase():
    import os

    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "TMPDIR": tmp}
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", XLSTM,
               "--requests", "3", "--ttl", "0", "--gap", "0.1", "--seq", "16",
               "--decode-steps", "2"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
    lines = proc.stdout.strip().splitlines()
    for ln in lines:
        print(f"launcher | {ln}")
    print(f"launcher: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if (proc.returncode != 0 or sum(" COLD " in ln for ln in lines) != 3
            or not lines or not lines[-1].startswith("summary")):
        _fail(f"python -m repro_torch.launch.serve: exit {proc.returncode}, "
              f"stderr {proc.stderr[-2000:]}")


def drivers_phase():
    """The engine driver on the card, then the closed calibration loop."""
    import os

    from repro_torch.analyze.calibrate import (fidelity_report, format_fidelity,
                                               measured_costs, write_calibration)
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.events import EventLog
    from repro_torch.experiments import registry, runner

    base = CostModel()
    events, functions = [], {}
    for name in ENGINE_DRIVER_CELLS:
        sc = registry.get(name)
        log = EventLog()
        t0 = time.perf_counter()
        led = runner.run(sc, "engine", cost_model=base, events=log)
        wall = time.perf_counter() - t0
        n = len(list(runner.build_trace(sc)))
        startups = [e for e in log.events if e["kind"] == "startup"]
        print(f"drivers {name}: {len(led.records)} of {n} invocations served in {wall:.2f} s "
              f"wall ({sc.engine.arch} SMOKE, clock x{sc.engine.clock_speed:g}), "
              f"{len(startups)} startups, cold rate "
              f"{led.summary()['cold_start_frequency']:.3f}")
        if len(led.records) != n or n == 0:
            _fail(f"engine driver {name}: {len(led.records)} of {n} invocations served")
        if name != "engine_smoke":
            events.extend(log.events)
            functions.update(runner.build_trace(sc).functions)
    calib = measured_costs(events, functions, base)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.json")
        write_calibration(path, calib)
        fitted = CostModel.from_calibration(path)
    for key in ("compile_base_s", "load_bandwidth_gbps", "snapshot_restore_frac",
                "resume_paused_s"):
        print(f"calibration {key}: fitted {calib.get(key, 'no sample')} "
              f"(default {getattr(base, key)})")
    print(format_fidelity(fidelity_report(events, functions, base), title="fidelity[default]"))
    rows = fidelity_report(events, functions, fitted)
    print(format_fidelity(rows, title="fidelity[fitted]"))
    if not rows:
        _fail("the probe cells produced no startup samples")



# --------------------------------------------------------------------------- #
# phase 12: the gym's cluster-step launch (step offset + per-function extras)
# --------------------------------------------------------------------------- #
GYM_EPOCH = 60                  # the gym's epoch_steps (repro_torch.learn.gym)
# the shortest dependent chain of one active step, counted from the warp
# kernel's code (csrc/cluster_step.cu's header: ~470 cycles at 1.98 GHz)
CHAIN_FLOOR_US = 0.24
GYM_CHAIN_GRID = "batch_dense64"


def _cluster_gym_compare(torch, name, args, t_begin):
    """The extras kernel against the plain version with a step offset,
    fatal on a disagreement; returns (got, max |err|)."""
    from repro_torch.kernels import cluster_step as kc

    got = kc.cluster_sim_hopper(*args, t_begin=t_begin, extras=True)
    want = kc.cluster_sim_plain(*args, t_begin=t_begin, extras=True)
    torch.cuda.synchronize()
    err, ok = _cluster_agree(got, want)
    c, f, w = args[0].shape
    print(f"gym-kernel {name} C={c} F={f} W={w} K={args[7].shape[2]} T={args[3].shape[1]} "
          f"t_begin={t_begin} layout={kc.layout(f, w, args[7].shape[2])} extras "
          f"{tuple(got[4].shape)}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"cluster_step extras {name} (t_begin {t_begin}) disagrees with its plain version")
    return got, err


def _epochs(torch, a, e_steps):
    """(C, T, F) -> one contiguous (C, e_steps, F) tensor an epoch, T padded
    with zeros to whole epochs (those steps lie past every horizon)."""
    c, t, f = a.shape
    n = -(-t // e_steps)
    pad = torch.zeros((c, n * e_steps - t, f), dtype=a.dtype, device=a.device)
    full = torch.cat([a, pad], dim=1)
    return [full[:, e * e_steps:(e + 1) * e_steps].contiguous() for e in range(n)]


def gym_kernel_phase(torch, dev):
    """The fixtures (warp layout) and the wide table (block layout) with a
    step offset and extras; then batch_dense64's tables in 60-step epochs,
    kernel and plain version each chained with its own state, compared epoch
    by epoch; then the extras-free sweep launch re-timed beside the extras
    launch, in turns."""
    import numpy as np
    from repro_torch.core import batchsim
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import cluster_step as kc
    from repro_torch.kernels import ref as R

    cases = [(f"fixture{s}", 3 + 4 * s,
              kernel_order(random_tables(np.random.default_rng(s)))) for s in range(3)]
    cases.append(("wide", 70, kernel_order(random_tables(
        np.random.default_rng(3), C=64, F=256, W=64, K=8, T=256, worker_mb=262144.0))))
    for name, t_begin, arrays in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        _cluster_gym_compare(torch, name, args, t_begin)

    cells = registry.get_sweep(GYM_CHAIN_GRID).scenarios()
    tables = batchsim.build_tables(cells, trace_fn=runner.build_trace)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in table_args(tables)]
    arr_e, conc_e = _epochs(torch, args[3], GYM_EPOCH), _epochs(torch, args[4], GYM_EPOCH)
    k_state, p_state = args[:3], args[:3]
    k_agg = torch.zeros((args[0].shape[0], R.AG_N), dtype=torch.float32, device=dev)
    worst, plain_s = 0.0, 0.0
    for e, (a, c) in enumerate(zip(arr_e, conc_e)):
        ep = [*k_state, a, c, *args[5:]]
        got = kc.cluster_sim_hopper(*ep, t_begin=e * GYM_EPOCH, extras=True)
        t0 = time.perf_counter()
        want = kc.cluster_sim_plain(*p_state, a, c, *args[5:], t_begin=e * GYM_EPOCH,
                                    extras=True)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        err, ok = _cluster_agree(got, want)
        worst = max(worst, err)
        if not ok:
            _fail(f"{GYM_CHAIN_GRID} epoch {e}: chained kernel state / agg / extras "
                  f"disagree with the chained plain version")
        k_state, p_state = got[:3], want[:3]
        k_agg = k_agg + got[3]
    print(f"gym-kernel {GYM_CHAIN_GRID} in {len(arr_e)} chained epochs of {GYM_EPOCH} steps "
          f"(C={args[0].shape[0]} F={args[0].shape[1]} W={args[0].shape[2]}): state, agg and "
          f"extras within rtol {CLUSTER_TOL['rtol']} atol {CLUSTER_TOL['atol']} every epoch, "
          f"max_abs_err={worst:.3e}; plain chain {plain_s:.2f} s")
    whole = kc.cluster_sim_hopper(*args)
    err, ok = _cluster_agree([*k_state, k_agg], whole)
    print(f"gym-kernel {GYM_CHAIN_GRID}: {len(arr_e)} chained launches vs one sweep launch: "
          f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{GYM_CHAIN_GRID}: the chained epochs end elsewhere than the one-launch sweep")
    sweep = lambda: kc.cluster_sim_hopper(*args)                               # noqa: E731
    extras = lambda: kc.cluster_sim_hopper(*args, extras=True)                 # noqa: E731
    times = [_graph_ms(torch, fn, reps=2, iters=5) for fn in (sweep, extras, extras, sweep)]
    print(f"time cluster_step fp32 ({GYM_CHAIN_GRID}, one launch over T "
          f"{args[3].shape[1]}), device (graph replay), in turns sweep / extras / extras / "
          f"sweep: {' / '.join(f'{t:.4f}' for t in times)} ms (the sweep kernel before the "
          f"extras: 1.51 ms, PERF.md §6)")
    return dict(sweep_ms=(times[0] + times[3]) / 2, extras_ms=(times[1] + times[2]) / 2)


# --------------------------------------------------------------------------- #
# phase 13: the RL keep-alive gym and the DQN agent on the card
# --------------------------------------------------------------------------- #
SCHEDULE = ROOT / "checkpoints" / "keepalive_schedule.json"


def _same_eval(what, got, want):
    ok = (abs(got["reward"] - want["reward"]) <= 1e-4 * abs(want["reward"])
          and abs(got["cold_starts"] - want["cold_starts"]) <= 1e-2
          and abs(got["idle_gb_s"] - want["idle_gb_s"])
          <= CLUSTER_TOL["atol"] + CLUSTER_TOL["rtol"] * abs(want["idle_gb_s"]))
    print(f"gym {what}: card reward {got['reward']:.4f} cold {got['cold_starts']:.4f} idle "
          f"{got['idle_gb_s']:.4f} | CPU reward {want['reward']:.4f} cold "
          f"{want['cold_starts']:.4f} idle {want['idle_gb_s']:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"gym {what}: the card disagrees with the CPU")


def gym_phase(torch, dev):
    """BatchSimGym(training_scenarios()) on the card: baseline_rewards (one
    cluster-step launch an epoch, counted), evaluate_schedule on the
    committed schedule, each against the same gym on the CPU; the gym's
    launch timed against its bound; train_agent + export_schedule; wall per
    epoch and per episode, and the busy share of one traced episode."""
    import numpy as np
    from repro_torch.kernels import cluster_step as kc
    from repro_torch.learn import agent
    from repro_torch.learn.gym import BatchSimGym, training_scenarios

    gym = BatchSimGym(training_scenarios(), device=dev)
    host = BatchSimGym(training_scenarios(), device="cpu")
    print(f"gym: C={gym.C} F={gym.F} W={gym.tables.nw.shape[2]} K={gym.tables.dwell.shape[2]}, "
          f"{gym.num_epochs} epochs of {gym.epoch_steps} steps (T {gym.tables.arrivals.shape[1]} "
          f"padded to {gym.num_epochs * gym.epoch_steps}), {len(gym.actions)} actions")
    gym.baseline_rewards()                          # warm-up (build, caching allocator)
    kc.launches = 0                                 # the gym's main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = gym.baseline_rewards()
    wall = time.perf_counter() - t0
    launches = kc.launches                          # read just after it
    want = len(gym.actions) * gym.num_epochs
    print(f"gym baseline_rewards on the card: {launches} cluster_step launches (expected "
          f"{len(gym.actions)} actions x {gym.num_epochs} epochs = {want}) in {wall:.3f} s, "
          f"{wall / want * 1e3:.3f} ms an epoch, {wall / len(gym.actions) * 1e3:.2f} ms an "
          f"episode")
    if launches != want:
        _fail(f"gym baseline_rewards: {launches} cluster_step launches != {want}")
    t0 = time.perf_counter()
    host_base = host.baseline_rewards()
    print(f"gym baseline_rewards on the CPU (plain version): {time.perf_counter() - t0:.2f} s")
    for a in gym.actions:
        _same_eval(f"fixed {a:g} s", base[a], host_base[a])
    sched = json.loads(SCHEDULE.read_text())
    _same_eval("evaluate_schedule(checkpoints/keepalive_schedule.json)",
               agent.evaluate_schedule(gym, sched["warm_s"]),
               agent.evaluate_schedule(host, sched["warm_s"]))

    # the gym's launch alone: a mid-episode epoch (every step inside the horizon)
    e = gym.num_epochs // 2
    state, _ = gym.reset()
    grid = torch.full((gym.C, gym.F), 30.0, device=dev)
    for _ in range(e):
        state, _, _, _ = gym.step(state, grid)
    ep_args, t_begin = gym.launch_args(state, grid)
    out = kc.cluster_sim_hopper(*ep_args, t_begin=t_begin, extras=True)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    kc.cluster_sim_plain(*ep_args, t_begin=t_begin, extras=True)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    launch = lambda: kc.cluster_sim_hopper(*ep_args, t_begin=t_begin, extras=True)  # noqa: E731
    ms = _graph_ms(torch, launch, reps=20, iters=10)
    launch_ms = _time_ms(torch, launch, iters=50)
    bound = _cluster_bound(ep_args, out, t_begin=t_begin)
    print(f"time cluster_step fp32 (gym epoch {e}: C={gym.C} F={gym.F} E={gym.epoch_steps}, "
          f"extras): kernel {ms:.4f} ms device (graph replay), {launch_ms:.4f} ms launch by "
          f"launch; plain {plain_ms:.3f} ms (one call), library none, bound {bound[0]:.6f} ms "
          f"({bound[1]}); chain floor {gym.epoch_steps * CHAIN_FLOOR_US / 1e3:.4f} ms "
          f"({gym.epoch_steps} dependent steps)")
    _, err = _cluster_gym_compare(torch, f"gym epoch {e}", ep_args, t_begin)

    t0 = time.perf_counter()
    params, hist = agent.train_agent(gym, episodes=3, log_every=1)
    train_s = time.perf_counter() - t0
    warm_s, metrics, method = agent.export_schedule(gym, params, log_fn=print)
    losses = [h["loss"] for h in hist]
    print(f"gym train_agent(episodes=3) on the card: {train_s:.2f} s "
          f"({train_s / 3:.2f} s an episode), losses {losses}; export_schedule {method}: "
          f"reward {metrics['reward']:.4f}, warm_s {warm_s}")
    if not all(np.isfinite(losses)):
        _fail(f"train_agent losses not finite: {losses}")
    names = {n for fn in gym.function_names for n in fn}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "schedule.json"
        agent.save_schedule(str(path), warm_s, meta={"method": method, "episodes": 3})
        got = json.loads(path.read_text())
    if (set(got) != set(sched) or set(warm_s) != names
            or not set(warm_s.values()) <= set(gym.actions)):
        _fail(f"exported schedule does not follow checkpoints/keepalive_schedule.json: {got}")

    episode = lambda: gym.evaluate(np.full((gym.C, gym.F), 30.0, np.float32))  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episode()
    wall_ep = time.perf_counter() - t0
    _profile_call(torch, wall_ep, episode,
                  f"gym episode (evaluate, {gym.num_epochs} epochs)")
    return launches, dict(max_abs_err=err, ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                          library_ms=None, bound=bound)


# --------------------------------------------------------------------------- #
# phase 14: the trained forecaster and the learned predictors on the card
# --------------------------------------------------------------------------- #
FORECASTER_CKPT = ROOT / "checkpoints" / "forecaster.npz"
# card vs CPU on one set of weights: two fp32 attention layers, sums in
# another order (the CPU tests hold the port to the reference within 1e-5)
FORECASTER_TOL = 1e-4
FORECASTER_BATCHES = (1, 256)       # serving (one window), and a batch of windows
# one learn_grid cell under prewarm_lstm, its horizon cut from 600 s: the
# whole cell took 53 s on the card (an eager LSTM of ~8 steps an arrival
# and 40 Adam steps every 32 arrivals of a function, all host-bound)
LSTM_HORIZON_S = 300.0


def forecaster_flash(torch, dev):
    """The flash kernel at the forecaster's shape (fp32, (B, 16, 4, 8), causal,
    q_pos = kv_pos = arange(16)) against its plain version; kernel, plain and
    SDPA timed by graph replay."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import roofline

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for b in FORECASTER_BATCHES:
        q, k, v = (torch.randn((b, 16, 4, 8), generator=gen, device=dev) for _ in range(3))
        pos = torch.arange(16, device=dev, dtype=torch.int32)
        got = kf.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos)
        want = kf.flash_attention_plain(q, k, v, q_pos=pos, kv_pos=pos)
        torch.cuda.synchronize()
        err, ok = _close(got, want, KERNEL_TOL["float32"])
        print(f"kernel flash_attention float32 forecaster 4/4 D=8 B={b} S=16 causal: "
              f"max_abs_err={err:.3e} tol={KERNEL_TOL['float32']} {'ok' if ok else 'FAIL'}")
        if not ok or not torch.isfinite(got).all():
            _fail(f"flash_attention at the forecaster shape (B {b}) disagrees with its plain "
                  f"version")
        pairs = 16 * 17 // 2
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        t = _attn_times(torch, lambda: kf.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos),
                        lambda: kf.flash_attention_plain(q, k, v, q_pos=pos, kv_pos=pos),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        t.update(max_abs_err=err, bound=_bound(roofline.flash_work(b, 16, 16, 4, 4, 8, 4,
                                                                   pairs)))
        print(f"time flash_attention fp32 (forecaster, B {b}, 4/4 heads, D 8, S 16), device "
              f"(graph replay): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms ({t['bound'][1]}); "
              f"kernel launch by launch (host included) {t['launch_ms']:.4f} ms")
        out[b] = t
    return out


def _forecaster_windows(n=64):
    """``n`` feature windows of a seeded cron trace, every history length."""
    import numpy as np
    from repro_torch.core.workload import cron_spikes
    from repro_torch.learn.features import FeatureConfig, encode_window

    feat = FeatureConfig()
    tr = cron_spikes(18_000.0, num_functions=4, base_gap_s=240.0, spike_gap_s=75.0,
                     spike_period_s=7200.0, jitter=0.05, seed=11)
    xs = []
    for fn in tr.functions:
        times = np.asarray(tr.times_for(fn))
        gaps, ends = np.diff(times), times[1:]
        xs += [encode_window(gaps[:j], ends[:j], feat) for j in range(1, len(gaps) + 1)]
    idx = np.random.default_rng(0).choice(len(xs), size=n, replace=False)
    return np.stack([xs[i] for i in idx])


def forecaster_phase(torch, dev):
    """The committed checkpoint read without JAX; apply_forecaster card vs
    CPU; the predictor's flash launches and ms per prediction; then the
    learn scenario under prewarm_transformer and a prewarm_lstm cell, each
    on the card and on the CPU.  Returns the flash launches of the
    forecaster's main path (the learn run)."""
    import numpy as np
    from repro_torch.core.metrics import format_summary
    from repro_torch.core.predictors.transformer import TransformerPredictor
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.learn.forecaster import apply_forecaster, load_forecaster
    from repro_torch.training import checkpoint

    leaves, extra = checkpoint.read_reference(str(FORECASTER_CKPT))
    print(f"forecaster checkpoint {FORECASTER_CKPT.relative_to(ROOT)}: {len(leaves)} leaves, "
          f"{sum(a.size for a in leaves)} parameters, extra model {extra['model']}, "
          f"jax loaded: {'jax' in sys.modules}")
    if "jax" in sys.modules:
        _fail("reading the forecaster checkpoint loaded jax")
    card, cfg, feat, _ = load_forecaster(str(FORECASTER_CKPT), device=dev)
    host, _, _, _ = load_forecaster(str(FORECASTER_CKPT), device="cpu")
    x = _forecaster_windows()
    with torch.no_grad():
        got = apply_forecaster(card, torch.from_numpy(x).to(dev), cfg).cpu()
        want = apply_forecaster(host, torch.from_numpy(x), cfg)
    err, ok = _close(got, want, FORECASTER_TOL)
    print(f"forecaster apply_forecaster on {len(x)} windows, card vs CPU: max |err| "
          f"{err:.3e} on (q05, q50, q95) tol={FORECASTER_TOL} {'ok' if ok else 'FAIL'}")
    if not ok or got.shape != (len(x), 3) or not (got[:, 1:] >= got[:, :-1]).all():
        _fail("apply_forecaster on the card disagrees with the CPU or is unordered")

    pred = TransformerPredictor(str(FORECASTER_CKPT), device=dev)
    pred.observe(0.0)
    gaps = np.random.default_rng(3).uniform(60.0, 300.0, 40)
    times = np.cumsum(gaps)
    per_pred = []
    for t in times[:8]:
        pred.observe(float(t))
        before = kf.launches
        pred.window()
        pred.predict_next()
        per_pred.append(kf.launches - before)
    print(f"forecaster predictions: flash launches per prediction {per_pred} (expected 2: "
          f"one a layer; predict_next reads the cached window's forward)")
    if set(per_pred) != {2}:
        _fail(f"forecaster: {per_pred} flash launches per prediction, not 2")
    t = float(times[8])

    def predict():
        nonlocal t
        t += 120.0
        pred.observe(t)
        return pred.predict_next()

    n_dev = _device_launches(torch, predict)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        predict()
    ms = (time.perf_counter() - t0) / 50 * 1e3
    print(f"forecaster prediction on the card: {ms:.3f} ms each (encode + (1, 16, 10) forward "
          f"+ host copy), {n_dev} device launches each (profiler), 2 of them flash")

    sc = registry.get("learn")
    kf.launches = 0                                   # the forecaster's main path starts here
    t0 = time.perf_counter()
    led = runner.run(sc, "sim", device=dev)
    wall = time.perf_counter() - t0
    launches = kf.launches                            # read just after it
    s = led.summary()
    print(f"{format_summary('learn[sim] ' + sc.policy + ' card', s)}")
    print(f"learn[sim] on the card: {wall:.2f} s wall, {launches} flash launches "
          f"({launches // 2} predictions)")
    t0 = time.perf_counter()
    s_host = runner.run(sc, "sim", device="cpu").summary()
    print(f"learn[sim] on the CPU: {time.perf_counter() - t0:.2f} s wall; requests "
          f"{s_host['requests']} / {s['requests']}, cold rate {s_host['cold_start_frequency']:.6f} "
          f"/ {s['cold_start_frequency']:.6f} (CPU / card)")
    if launches == 0 or s["requests"] != s_host["requests"] or s["requests"] == 0:
        _fail("learn under prewarm_transformer: no flash launch, or requests differ card / CPU")

    cell = registry.get_sweep("learn_grid").scenarios()[0].with_overrides(
        {"policy": "prewarm_lstm", "workload.params.horizon": LSTM_HORIZON_S})
    t0 = time.perf_counter()
    s_lstm = runner.run(cell, "sim", device=dev).summary()
    wall = time.perf_counter() - t0
    print(f"{cell.name}[sim] prewarm_lstm on the card ({cell.workload.params}): requests "
          f"{s_lstm['requests']}, cold rate {s_lstm['cold_start_frequency']:.6f}, idle "
          f"{s_lstm['idle_gb_s']:.2f} GB-s, in {wall:.2f} s wall")
    if s_lstm["requests"] == 0:
        _fail("prewarm_lstm served no request")
    return launches


# --------------------------------------------------------------------------- #
# phases 15-17: the encoder-decoder and vision families, and fuse_chain
# --------------------------------------------------------------------------- #

# whisper-large-v3 at its published decoder context (n_text_ctx 448,
# arXiv:2212.04356); 1500 encoder frames of d 1280
ENCDEC, ENCDEC_SEQ = "whisper-large-v3", 448
# internvl2-1b with 256 image embeddings a request; the fp32 model phase's
# prompt keeps 300 - 256 = 44 text tokens
VISION, VISION_PROMPT = "internvl2-1b", 300
# internvl2 trains at S 512: its 256 image embeddings take the first 256
# positions of a sequence (the model keeps S the tokens' length and labels
# none of them), so at the launcher's S 256 no position would carry a label
VISION_TRAIN_SEQ = 512
# fuse_chain's pair (tests/test_serving.py's): granite -> h2o-danube-3
CHAIN = ("granite-3-2b", "h2o-danube-3-4b")


def _extras(torch, cfg, batch: int = 1):
    """Random draws of the prefill's other input (whisper's frames, internvl2's
    image embeds) for ``batch`` rows: from a torch Generator (the model phase)
    and from a numpy Generator (a request's extras, fp32; the engine casts
    them)."""
    key, shape = (("frames", (batch, cfg.encoder.num_frames, cfg.encoder.d_model))
                  if cfg.encoder is not None else
                  ("image_embeds", (batch, cfg.vision.num_image_tokens, cfg.vision.d_embed)))
    return (lambda gen: {key: torch.randn(shape, generator=gen, device=gen.device)},
            lambda rng: {key: rng.standard_normal(shape).astype("float32")})


def encdec_phase(torch, dev):
    """whisper-large-v3 at full width: fp32 kernel path vs oracle path (a
    120-token prefill on 1500 random frames, 4 decode steps below max_seq);
    the bf16 engine with frames (96 flash launches a prefill: encoder,
    decoder self, cross; 64 decode launches a step: self, cross); one
    ServerlessRouter COLD then warm request with extras."""
    from repro_torch.config import get_config

    cfg = get_config(ENCDEC)
    model_extras, request_extras = _extras(torch, cfg)
    model_phase(torch, dev, dataclasses.replace(cfg, dtype="float32", param_dtype="float32"),
                f"{ENCDEC} fp32", max_seq=ENCDEC_SEQ, extras=model_extras)
    n = cfg.num_layers
    launches = engine_phase(torch, ENCDEC, max_seq=ENCDEC_SEQ, launches=(3 * n, 2 * n),
                            extras=request_extras, zero_tail=True, designs=False)
    _free(torch)
    router_extras_phase(torch, ENCDEC, ENCDEC_SEQ, (3 * n, 2 * n))
    return launches


def vision_phase(torch, dev):
    """internvl2-1b at full width: fp32 kernel path vs oracle path with 256
    image embeddings; the bf16 engine with image_embeds (24 flash launches a
    prefill, 24 decode launches a step)."""
    from repro_torch.config import get_config

    cfg = get_config(VISION)
    model_extras, request_extras = _extras(torch, cfg)
    model_phase(torch, dev, dataclasses.replace(cfg, dtype="float32", param_dtype="float32"),
                f"{VISION} fp32", prompt=VISION_PROMPT, extras=model_extras)
    launches = engine_phase(torch, VISION, extras=request_extras, designs=False)
    _free(torch)
    return launches


def router_extras_phase(torch, arch, max_seq, per):
    """One function behind a ServerlessRouter: a COLD then a warm request,
    each with ``extras``; exact launches, equal tokens, warm faster."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.fleet.pool import EngineProfile
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serving.engine import SnapshotStore
    from repro_torch.serving.router import FunctionDef, ServerlessRouter

    cfg = get_config(arch)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (1, max_seq)).astype(np.int32)
    extras = _extras(torch, cfg)[1](rng)
    with tempfile.TemporaryDirectory() as snapdir:
        router = ServerlessRouter(ttl_s=300.0, store=SnapshotStore(snapdir))
        router.register(FunctionDef("f", arch, max_seq=max_seq, decode_steps=DECODE_STEPS))
        router.backend.profiles["f"] = EngineProfile(arch=arch, max_seq=max_seq,
                                                     decode_steps=DECODE_STEPS, smoke=False)
        kf.launches = kd.launches = 0                 # the router's path starts here
        outs, recs = [], []
        for what, warm_ups in (("first", 1), ("second", 0)):
            c = (kf.launches, kd.launches)
            out, rec = router.invoke("f", tokens, extras=extras)
            got = (kf.launches - c[0], kd.launches - c[1])
            want = (per[0] * (1 + warm_ups), per[1] * (DECODE_STEPS + warm_ups))
            print(f"router {arch} {what}: {'COLD' if rec.cold else 'warm'} latency "
                  f"{rec.latency * 1e3:.2f} ms startup {rec.startup}; launches flash_attention, "
                  f"decode_attention {got} (expected {want}); tokens {out[0].tolist()}")
            if got != want:
                _fail(f"router {arch} {what}: launch counts {got} != {want}")
            outs.append(out)
            recs.append(rec)
        if not (recs[0].cold and not recs[1].cold and recs[1].latency < recs[0].latency):
            _fail(f"router {arch}: expected COLD then a faster warm request")
        if not np.array_equal(outs[0], outs[1]):
            _fail(f"router {arch}: warm tokens {outs[1]} != cold tokens {outs[0]}")
    _free(torch)


def chain_phase(torch):
    """fuse_chain over full-width granite-3-2b -> h2o-danube-3-4b (bf16,
    max_seq 512, 16 decode steps a stage) as one CUDA graph: the replay's
    tokens against the stages run one after another eagerly through
    engine.generate; compile_s, replay ms and the eager chain's ms."""
    import numpy as np
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serving.engine import InferenceEngine, fuse_chain, generate

    engines = []
    for arch in CHAIN:
        eng = InferenceEngine(arch, smoke=False, max_seq=MAX_SEQ, store=None, device="cuda")
        eng.cold_start()
        engines.append(eng)
    layers = sum(e.bundle.cfg.num_layers for e in engines)
    kf.launches = kd.launches = 0                     # the chain's path starts here
    fn, compile_s = fuse_chain(engines, decode_steps=DECODE_STEPS)
    got = (kf.launches, kd.launches)                  # the wrappers ran twice: warm-up, capture
    want = (2 * layers, 2 * layers * DECODE_STEPS)
    print(f"chain {' -> '.join(CHAIN)}: compile_s {compile_s:.3f} s (warm-up + capture + "
          f"instantiate); launches through the wrappers flash_attention, decode_attention "
          f"{got} (expected {want}: the warm-up and the capture; a replay runs the captured "
          f"launches)")
    if got != want:
        _fail(f"chain launch counts {got} != {want}")

    def eager(tokens):
        for eng in engines:
            tokens = tokens % eng.bundle.cfg.vocab_size
            gen, _ = generate(eng.bundle, eng.params, tokens, decode_steps=DECODE_STEPS)
            tokens = np.concatenate([tokens, gen], axis=1)[:, -MAX_SEQ:]
        return tokens

    rng = np.random.default_rng(11)
    for i in range(2):
        tokens = rng.integers(0, 1 << 16, (1, MAX_SEQ)).astype(np.int32)
        out = fn({"tokens": tokens}).cpu().numpy()
        want_tokens = eager(tokens)
        print(f"chain request {i}: graph tokens {out[0, -DECODE_STEPS:].tolist()} (last "
              f"{DECODE_STEPS}), eager {'equal' if np.array_equal(out, want_tokens) else 'DIFFER'}")
        if out.shape != (1, MAX_SEQ) or not np.array_equal(out, want_tokens):
            _fail(f"chain request {i}: the graph's tokens differ from the eager chain's")
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn({"tokens": tokens})
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        eager(tokens)
    eager_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"chain time: graph replay {replay_ms:.2f} ms a chain (host clock, {reps} runs, "
          f"input copy and output clone included), eager through engine.generate "
          f"{eager_ms:.2f} ms ({eager_ms / replay_ms:.2f}x)")
    for eng in engines:
        eng.shutdown()
    del fn
    _free(torch)


# --------------------------------------------------------------------------- #
# phases 18-24: training — the flash backward kernel, full-width granite-3-2b
# gradients (fp32) and optimizer steps (bf16, launch/train.py), the
# forecaster's trainer, SMOKE whisper / internvl2 steps, train -> checkpoint
# -> serve, and the guard on the kernels with no backward
# --------------------------------------------------------------------------- #

BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the forward's row statistics against the plain version's: fp32 sums in
# another order; in bf16 also ex2.approx (2^-22 relative) and m's trip through
# the kernel's log2 domain
STATS_TOL = 1e-4
# the simple SIMT backward (three launches, no tensor cores) that the
# tensor-core kernels replaced, at the timed training shapes (this script on
# an H100 80GB HBM3 at 700.00 W), printed beside this run's
SIMT_BWD_MS = {("granite", "train"): 0.9681, ("forecaster", "train"): 0.0341}
TRAIN_STEPS = 10
TRAIN_SHAPE = (8, 256)         # launch/train.py's default batch and seq
DECODE_32K_B = 8              # decode_32k's global batch 128 cut to what one card holds
TRAIN_4K_BATCHES = (8, 4, 2, 1)   # train_4k's 256 cut: the largest of these that fits
TRAIN_4K_SEQ, TRAIN_4K_STEPS = 4096, 5
# a plain version whose whole call's fp32 score tensor passes this runs one
# batch row at a time (train_4k's B 8 backward would hold ~70 GB)
PLAIN_BYTES = 4 << 30
GRAD_TOL = dict(loss=1e-5, norm=1e-4, leaf=1e-3)
FORECASTER_TRAIN_B = 64        # the reference trainer's batch (scripts/train_predictors.py)
FORECASTER_TRAIN_STEPS = 10
SMOKE_TRAIN_TOL = 1e-4
# (shape, name, B, Sq, Skv, window, causal, key shift): the forward phase's
# cases at B 1, granite's training shape, the forecaster's, a prefill whose
# keys start at position 40 (q rows 0-39 see no valid key), and train_4k at
# its first batch (the one that fits: the train_4k phase prints each try)
BWD_CASES = [(shape, name, 1, sq, skv, window, causal, 0)
             for shape, name, sq, skv, window, causal in FLASH_CASES] + [
    ("granite", "train", *TRAIN_SHAPE, TRAIN_SHAPE[1], None, True, 0),
    ("forecaster", "train", FORECASTER_TRAIN_B, 16, 16, None, True, 0),
    ("granite", "no_valid_key", 1, 100, 100, None, True, 40),
    ("granite", "train_4k", TRAIN_4K_BATCHES[0], TRAIN_4K_SEQ, TRAIN_4K_SEQ, None, True, 0),
    # the full-width training steps of whisper (B 8 x S 256 on 1500 frames:
    # its encoder, its cross and its decoder's self-attention) and internvl2
    # (256 image positions before 256 text tokens)
    ("whisper", "train_encoder", TRAIN_SHAPE[0], 1500, 1500, None, False, 0),
    ("whisper", "train_cross", TRAIN_SHAPE[0], TRAIN_SHAPE[1], 1500, None, False, 0),
    ("whisper", "train_decoder", *TRAIN_SHAPE, TRAIN_SHAPE[1], None, True, 0),
    ("internvl2", "train", TRAIN_SHAPE[0], VISION_TRAIN_SEQ, VISION_TRAIN_SEQ, None, True, 0)]
# the cases timed, each with its graphs' (reps, iters): the training paths'
BWD_TIMED = {("granite", "train", "bfloat16"): (20, 10),
             ("forecaster", "train", "float32"): (20, 10),
             ("granite", "train_4k", "bfloat16"): (2, 3),
             ("whisper", "train_encoder", "bfloat16"): (5, 4),
             ("whisper", "train_cross", "bfloat16"): (20, 10),
             ("whisper", "train_decoder", "bfloat16"): (20, 10),
             ("internvl2", "train", "bfloat16"): (20, 10)}
# in bf16 also the row gate (ROW_TOL) on the backward and the forward's output,
# and the backward without its last key tile (the partial one at Skv 1500)
BWD_LONG = {("granite", "train_4k"), ("whisper", "train_encoder"), ("whisper", "train_cross"),
            ("whisper", "train_decoder"), ("internvl2", "train")}
# the scan's backward against its plain version: fp32 sums over channels,
# time and states in another order (the flash backward's 1e-4); bf16 du, dB
# and dC are one rounding of an fp32 sum
SSM_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the first, simple scan backward (synchronous staging, 28 shuffles a step)
# at the Jamba training shape (bf16) and SMOKE's (fp32), device ms by graph
# replay (this script on an H100 80GB HBM3 at 700.00 W), printed beside this
# run's
SIMPLE_SSM_BWD_MS = {"jamba": 0.6489, "smoke": 0.0153}
# the hybrid family trains at full width cut to its first two layers: "MM",
# one dense and one MoE FFN (the period is lcm(pattern, every_n_layers 2) =
# 2 layers, the fewest), 3.742 B parameters; only depth cut, from 32
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_PATTERN = 2, "MM"
HYBRID_GRAD_SHAPE = (1, 256)   # the fp32 gradient check's B x S
HYBRID_TRAIN_STEPS = 10
# SMOKE jamba's train step (smoke_train_phase): B 2 x S 32
SMOKE_TRAIN_SHAPE = (2, 32)
# granite's bf16 train step with the functional AdamW update (this script on
# an H100 80GB HBM3 at 700.00 W), printed beside this run's
GRANITE_TRAIN_BEFORE = dict(peak_gb=61.79, step_ms=507.1)


def _batch_rows(torch, fn, tensors, args):
    """``fn`` one batch row at a time, its outputs joined on the batch dim:
    a plain version whose whole call would not fit."""
    parts = [fn(*(t[i:i + 1] for t in tensors), **args) for i in range(tensors[0].shape[0])]
    return tuple(torch.cat(p) for p in zip(*parts))


def flash_bwd_phase(torch, dev):
    """On every case of BWD_CASES, fp32 and bf16: the forward's row statistics
    against its plain version's and its output with them bit-equal to its
    output without; the flash backward kernel against its plain version, two
    calls bit-equal (at BWD_LONG's bf16 cases also the row gate on the
    gradients and the forward's output, which must refuse the backward with
    its last key tile dropped).  At the training paths' shapes
    (BWD_TIMED) the backward and the forward (the training path's, with
    statistics, and serving's) timed by graph replay beside the plain
    versions and, as a yardstick, scaled_dot_product_attention's forward and
    backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import attention_mask
    from repro_torch.launch import roofline

    gen = torch.Generator(device=dev).manual_seed(12)
    timed = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for shape, name, b, sq, skv, window, causal, shift in BWD_CASES:
            hq, hkv, d = ATTN_SHAPES[shape]
            q, dout = (torch.randn((b, sq, hq, d), generator=gen, device=dev).to(tdt)
                       for _ in range(2))
            k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(tdt)
                    for _ in range(2))
            q_pos = torch.arange(sq, device=dev, dtype=torch.int32) + (skv - sq if causal else 0)
            kv_pos = torch.arange(skv, device=dev, dtype=torch.int32) + shift
            args = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
            serving = kf.flash_attention_hopper(q, k, v, **args)
            out, m, linv = kf.flash_attention_hopper(q, k, v, **args, stats=True)
            got = kf.flash_attention_bwd_hopper(q, k, v, out, dout, m, linv, **args)
            again = kf.flash_attention_bwd_hopper(q, k, v, out, dout, m, linv, **args)
            sliced = b * hq * sq * skv * 4 > PLAIN_BYTES
            plain_ms = {}

            def plain(what, fn, tensors, **extra):
                if not sliced:
                    return fn(*tensors, **args, **extra)
                res = []
                plain_ms[what] = _event_ms(torch, lambda: res.append(_batch_rows(
                    torch, fn, tensors, dict(args, **extra))))
                return res[0]

            pout, pm, pl = plain("fwd", kf.flash_attention_plain, (q, k, v), stats=True)
            want = plain("bwd", kf.flash_attention_bwd_plain, (q, k, v, out, dout, m, linv))
            torch.cuda.synchronize()
            stat_errs = [_close(a, w, STATS_TOL) for a, w in ((m, pm), (linv, pl))]
            same_out = torch.equal(out, serving)
            errs = [_close(g, w, BWD_TOL[dtype]) for g, w in zip(got, want)]
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            ok = all(o for _, o in errs) and same and all(torch.isfinite(g.float()).all()
                                                         for g in got)
            rows = ""
            long = (shape, name) in BWD_LONG and dtype == "bfloat16"
            if long:
                row_errs = [_row_err(g, w) for g, w in zip((*got, out), (*want, pout))]
                ok = ok and all(r <= ROW_TOL for r in row_errs)
                rows = (f"row error dq {row_errs[0]:.3e} dk {row_errs[1]:.3e} dv "
                        f"{row_errs[2]:.3e} out {row_errs[3]:.3e} (ROW_TOL {ROW_TOL}) ")
            stats_ok = same_out and all(o for _, o in stat_errs)
            print(f"kernel flash_attention_bwd {dtype} {shape} {hq}/{hkv} D={d} {name} B={b} "
                  f"Sq={sq} Skv={skv} window={window} causal={causal} keys from {shift}: "
                  f"forward stats max rel err m {stat_errs[0][0]:.2e} linv {stat_errs[1][0]:.2e} "
                  f"(tol {STATS_TOL}), out bit-equal to serving's {same_out}; "
                  f"max_abs_err dq {errs[0][0]:.3e} dk {errs[1][0]:.3e} dv {errs[2][0]:.3e} "
                  f"tol={BWD_TOL[dtype]} {rows}bit-equal twice {same}"
                  f"{' (plain one batch row a call)' if sliced else ''} "
                  f"{'ok' if ok and stats_ok else 'FAIL'}")
            if not stats_ok:
                _fail(f"flash_attention {dtype} {shape} {name}: the row statistics disagree "
                      f"with the plain version's, or the output moved with them on")
            if not ok:
                _fail(f"flash_attention_bwd {dtype} {shape} {name} disagrees with its plain "
                      f"version or is not deterministic")
            if long:
                # the backward over every key but the last tile's (64, or the
                # partial tile's): dq misses their terms, their dk / dv rows stay 0
                cut = skv % FLASH_KEY_TILE or FLASH_KEY_TILE
                bad = kf.flash_attention_bwd_hopper(
                    q, k[:, :-cut].contiguous(), v[:, :-cut].contiguous(), out, dout, m, linv,
                    **dict(args, kv_pos=kv_pos[:-cut]))
                pad = torch.zeros_like(k[:, -cut:])
                bad = (bad[0], *(torch.cat([x, pad], dim=1) for x in bad[1:]))
                _gate_rejects(f"flash_attention_bwd {shape} {name} (the last {cut} keys)", dtype,
                              torch.cat([x.flatten(0, -2) for x in bad]),
                              torch.cat([x.flatten(0, -2) for x in want]), BWD_TOL)
                del bad
            if (shape, name, dtype) not in BWD_TIMED:
                del q, k, v, dout, out, m, linv, got, again, want
                continue
            reps, iters = BWD_TIMED[(shape, name, dtype)]
            pairs = attention_mask(q_pos, kv_pos, causal=causal, window=window).sum().item()
            label = f"B {b}, S {sq}, causal {causal}"
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # the training path's forward: with the statistics
            f = _attn_times(torch, lambda: kf.flash_attention_hopper(q, k, v, **args, stats=True),
                            lambda: kf.flash_attention_plain(q, k, v, **args, stats=True),
                            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                   enable_gqa=True),
                            reps=reps, iters=iters, plain_ms=plain_ms.get("fwd"))
            f.update(max_abs_err=_close(out, pout, KERNEL_TOL[dtype])[0], label=label,
                     bound=_bound(roofline.flash_work(b, sq, skv, hq, hkv, d, q.element_size(),
                                                      pairs, stats=True)))
            timed[("fwd", shape, name)] = f
            serving_ms = _graph_ms(torch, lambda: kf.flash_attention_hopper(q, k, v, **args),
                                   reps, iters)
            # SDPA's backward runs on its forward's stream, so a graph holds
            # the two together: its backward is (forward + backward) - forward
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            lib_dout = dout.transpose(1, 2)

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
                return torch.autograd.grad(o, leaves, lib_dout)

            def kernel():
                return kf.flash_attention_bwd_hopper(q, k, v, out, dout, m, linv, **args)

            fwd_bwd = _graph_ms(torch, sdpa_fwd_bwd, reps, iters)
            t = _attn_times(torch, kernel, lambda: kf.flash_attention_bwd_plain(
                q, k, v, out, dout, m, linv, **args), sdpa_fwd_bwd, reps=reps, iters=iters,
                plain_ms=plain_ms.get("bwd"))
            t["library_ms"] = fwd_bwd - f["library_ms"]
            # dq, dk, dv and the recomputed S, dP: five D-long products a pair
            t.update(max_abs_err=max(e for e, _ in errs), label=label,
                     bound=_bound(roofline.flash_bwd_work(b, sq, skv, hq, hkv, d,
                                                          q.element_size(), pairs)))
            timed[("bwd", shape, name)] = t
            simt = SIMT_BWD_MS.get((shape, name))
            print(f"time sdpa forward + backward {dtype} ({shape} {name}) {fwd_bwd:.4f} ms, "
                  f"forward {f['library_ms']:.4f} ms (graph replay)")
            print(f"time flash_attention_bwd {dtype} ({shape} {name}): {t['ms']:.4f} ms"
                  + ("" if simt is None else f" against the simple SIMT kernel's {simt:.4f} ms "
                     f"({simt / t['ms']:.2f}x)") + f"; forward with statistics {f['ms']:.4f} "
                  f"ms, serving's forward (none) {serving_ms:.4f} ms")
            _print_time("flash_attention_bwd", dtype, shape, name, t)
            _print_time("flash_attention", dtype, shape, name, f)
            del q, k, v, dout, out, m, linv, got, again, want, qt, kt, vt, leaves
        _free(torch)
    return timed


def _ssm_times(torch, args, ckpt, dy, dhT, got):
    """Device ms (graph replay) and launch-by-launch ms of the forward with
    checkpoints and of the backward at one shape, each plain version's ms
    (one call) and each bound.  The backward's least work: every input read
    and every output written once, each decay's exponential once, ~14 fp32
    operations a (b, t, d, n) for the gradient's sums."""
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.launch import roofline

    u, delta, A, B, C, D, h0 = args
    bt, t, din = u.shape
    n = A.shape[1]

    def plain_ms(fn):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    def fwd():
        return ks.ssm_scan_hopper(*args, checkpoints=True)

    def bwd():
        return ks.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)

    y, hT, _ = fwd()
    rows = {
        "fwd": dict(ms=_graph_ms(torch, fwd), launch_ms=_time_ms(torch, fwd),
                    plain_ms=plain_ms(lambda: ks.ssm_scan_plain(*args, checkpoints=True)),
                    serving_ms=_graph_ms(torch, lambda: ks.ssm_scan_hopper(*args)),
                    library_ms=None,
                    bound=_bound(roofline.ssm_scan_work(bt, t, din, n, u.element_size(),
                                                        checkpoints=True))),
        "bwd": dict(ms=_graph_ms(torch, bwd), launch_ms=_time_ms(torch, bwd),
                    plain_ms=plain_ms(lambda: ks.ssm_scan_bwd_plain(*args, ckpt, dy, dhT)),
                    library_ms=None,
                    bound=_bound(roofline.ssm_scan_bwd_work(bt, t, din, n,
                                                            u.element_size())))}
    return rows


def ssm_bwd_phase(torch, dev):
    """The scan's backward kernel (csrc/ssm_scan_bwd.cu): its ptxas and SASS
    report (phase 19 above), then against its plain version on the scan
    phase's fixtures, the extra edges, SMOKE jamba's train shape (B 2, T 32,
    Din 512, N 8) and the Jamba training shape (Bt 8, T 256, Din 8192, N
    16), fp32 and bf16, nonzero h0 and dhT, each twice and
    bit-equal; the forward with checkpoints bit-equal in y and hT to
    serving's forward, its checkpoints within SSM_TOL of the plain
    version's; the forward with checkpoints and the backward timed at the
    training shape (bf16) and at SMOKE's (fp32).  Returns those rows."""
    from repro_torch.config import get_config, reduced
    from repro_torch.kernels import ssm_scan as ks

    # the design as built: every instantiation's registers and spills, the
    # bf16 L 4 kernel's shuffles and exponentials over its unrolled segment
    built = [k for k in _ptxas_kernels("ssm_scan_bwd") if "ssm_bwd_kernel" in k[0]]
    if len(built) != 8:
        _fail(f"ptxas ssm_scan_bwd: {len(built)} ssm_bwd_kernel instantiations, not 8")
    for fn, regs, spill in built:
        kind = "bf16" if "nv_bfloat16" in fn else "fp32"
        print(f"ptxas ssm_bwd_kernel {kind} L {re.search(r'Li(\d+)E', fn).group(1)}: "
              f"{regs} registers, {spill} bytes spill stores")
    sass = _sass_counts("ssm_scan_bwd", ("SHFL", "MUFU.EX2"),
                        kernel=r"ssm_bwd_kernelI13__nv_bfloat16Li4E")
    if sass is None:
        print("sass ssm_bwd_kernel bf16 L 4: not measured (no cuobjdump)")
    else:
        # the reverse walk's segment is the one place with shuffles; the two
        # forward walks' segments (checkpoint walk, recompute) the only ones
        # with exponentials, which a chunk runs 1 + (NSEG - 1) / NSEG times
        nseg = ks.CHUNK // ks.SEGMENT
        shfl = sass["SHFL"] / ks.SEGMENT
        walks = sass["MUFU.EX2"] / (ks.SEGMENT * ks.STATES)
        ex2 = (1 + (nseg - 1) / nseg) if walks == 2 else float("inf")
        print(f"sass ssm_bwd_kernel bf16 L 4: SHFL {sass['SHFL']} in its {ks.SEGMENT}-step "
              f"segment, {shfl:.2f} a step (the simple kernel: 28); MUFU.EX2 "
              f"{sass['MUFU.EX2']}, {walks:g} walks of {ks.SEGMENT} steps x {ks.STATES} states "
              f"and none in the reverse walk: a decay taken {ex2:.2f} times (the simple kernel: 2.75)")
        if shfl > 9 or ex2 > 2:
            _fail(f"sass ssm_bwd_kernel bf16 L 4: {shfl:.2f} shuffles a step (at most 9), "
                  f"{sass['MUFU.EX2']} MUFU.EX2 (a decay at most twice)")

    gen = torch.Generator(device=dev).manual_seed(2)
    full, smoke = get_config(HYBRID), reduced(get_config(HYBRID))
    jamba = (*TRAIN_SHAPE, full.ssm.expand * full.d_model, full.ssm.d_state)
    smoke_case = (*SMOKE_TRAIN_SHAPE, smoke.ssm.expand * smoke.d_model, smoke.ssm.d_state)
    # the fixtures, N 32 and 5, the ring's edges (T 33, 257) at 1 and 8
    # lanes a channel and ragged Din, unaligned rows at 4 lanes (Din 100)
    cases = [(2, t, din, n) for t in (1, 37, 256, 300) for din in (64, 200)
             for n in (4, 8, 16)] + [(3, 65, 96, 32), (1, 40, 24, 5), (3, 33, 24, 1),
                                     (3, 257, 200, 17), (2, 33, 100, 16), smoke_case, jamba]
    timed, worst = {}, {}
    for dtype in ("float32", "bfloat16"):
        for case in cases:
            args = _ssm_inputs(torch, gen, *case, dtype)
            y0, hT0 = ks.ssm_scan_hopper(*args)
            y, hT, ckpt = ks.ssm_scan_hopper(*args, checkpoints=True)
            dy = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
            dhT = torch.randn(hT.shape, generator=gen, device=dev)
            got = ks.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)
            again = ks.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)
            want = ks.ssm_scan_bwd_plain(*args, ckpt, dy, dhT)
            want_ckpt = ks.ssm_scan_plain(*args, checkpoints=True)[2]
            torch.cuda.synchronize()
            serving_equal = torch.equal(y0, y) and torch.equal(hT0, hT)
            ck_err, ck_ok = _close(ckpt, want_ckpt, SSM_TOL[dtype])
            errs = [_close(g, w, SSM_BWD_TOL[dtype]) for g, w in zip(got, want)]
            err, ok = max(e for e, _ in errs), all(o for _, o in errs)
            equal = all(torch.equal(a, c) for a, c in zip(got, again))
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            if not (serving_equal and ck_ok and ok and equal
                    and all(torch.isfinite(g.float()).all() for g in got)):
                _fail(f"ssm_scan_bwd {dtype} Bt,T,Din,N={case}: forward with checkpoints "
                      f"equal to serving's {serving_equal}, checkpoints max_abs_err "
                      f"{ck_err:.3e} (tol {SSM_TOL[dtype]}), gradients max_abs_err "
                      f"{err:.3e} (tol {SSM_BWD_TOL[dtype]}), two calls bit-equal {equal}")
            key = ("jamba" if case == jamba and dtype == "bfloat16" else
                   "smoke" if case == smoke_case and dtype == "float32" else None)
            if key is None:
                continue
            names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dh0")
            print(f"kernel ssm_scan_bwd {dtype} {key} Bt,T,Din,N={case}: max_abs_err "
                  + ", ".join(f"{nm} {e:.3e}" for nm, (e, _) in zip(names, errs))
                  + f" (tol {SSM_BWD_TOL[dtype]}); two calls bit-equal; forward with "
                  f"checkpoints bit-equal to serving's, checkpoints max_abs_err {ck_err:.3e}")
            rows = _ssm_times(torch, args, ckpt, dy, dhT, got)
            for what, row in rows.items():
                row["max_abs_err"] = err if what == "bwd" else ck_err
                timed[(what, key)] = row
                extra = (f", serving's forward (no checkpoints) {row['serving_ms']:.4f} ms"
                         if what == "fwd" else
                         f", the simple kernel {SIMPLE_SSM_BWD_MS[key]:.4f} ms "
                         f"({SIMPLE_SSM_BWD_MS[key] / row['ms']:.2f}x)")
                print(f"time ssm_scan {what} {dtype} ({key} shape, Bt,T,Din,N={case}): kernel "
                      f"{row['ms']:.4f} ms device (graph replay), {row['launch_ms']:.4f} ms "
                      f"launch by launch (host included){extra}; plain {row['plain_ms']:.4f} "
                      f"ms (one call), library none, bound {row['bound'][0]:.5f} ms "
                      f"({row['bound'][1]}, {row['ms'] / row['bound'][0]:.2f}x)")
    print(f"kernel ssm_scan_bwd: {2 * len(cases)} cases ok, each twice and bit-equal, max_abs_err "
          f"fp32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}")
    return timed


def _train_counts():
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks

    return kf.launches, kf.bwd_launches, ks.launches, ks.bwd_launches


def _reset_train_counts():
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks

    kf.launches = kf.bwd_launches = ks.launches = ks.bwd_launches = 0


def _flash_calls(cfg) -> int:
    """Flash attention calls in one forward pass of ``cfg``: an encoder-decoder's
    encoder layers one each and its decoder layers two (self, cross); an
    LM's attention layers one each."""
    if cfg.encoder is not None:
        return cfg.encoder.num_layers + 2 * cfg.num_layers
    return cfg.layer_pattern.count("A")


def _serve_calls(cfg):
    """(flash calls a prefill, decode attention calls a decode step) of
    ``cfg``: a decoder layer of an encoder-decoder decodes against its self
    and its cross cache."""
    if cfg.encoder is not None:
        return _flash_calls(cfg), 2 * cfg.num_layers
    n = cfg.layer_pattern.count("A")
    return n, n


def _train_want(cfg, passes: int):
    """Launches of ``passes`` forward + backward passes of ``cfg``: flash
    forward, flash backward kernels, scan forward, scan backward kernels.
    Each attention call and Mamba layer runs its forward twice under remat
    (again in the backward) and its backward kernels once."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks

    fwd = 2 if cfg.remat else 1
    n_a, n_m = _flash_calls(cfg), cfg.layer_pattern.count("M")
    return (fwd * n_a * passes, kf.BWD_KERNELS * n_a * passes, fwd * n_m * passes,
            ks.BWD_KERNELS * n_m * passes)


COUNTS = "flash forward, flash backward, scan forward, scan backward kernels"


def hybrid_train_cfg():
    """Full-width jamba-v0.1-52b cut to its first two layers (bf16 weights)."""
    from repro_torch.config import get_config

    return dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_TRAIN_LAYERS,
                               block_pattern=HYBRID_TRAIN_PATTERN)


def _gate_grads(torch, label, got, want, names=("kernel", "plain"), zero=0.0):
    """GRAD_TOL on ``got`` = (loss, {leaf: grad}) against ``want``
    (``_grad_gap``): the loss, the gradient norm (both relative) and every
    leaf within ``leaf`` of its largest gradient; ``names`` label the two
    sides.  With ``zero``, a leaf whose gradient on both sides stays below
    ``zero`` x the largest gradient of any leaf is one whose exact gradient
    is 0 (rounding alone sets its digits, so it has no scale of its own): it
    is named, and passes only while both sides stay below that floor."""
    gk, gp = got[1], want[1]
    floor = zero * max(g.abs().max().item() for g in gp.values())
    zeros = [k for k in gp if max(gp[k].abs().max().item(), gk[k].abs().max().item()) < floor]
    gap = _grad_gap(torch, got, want, skip=zeros)
    if zero:
        print(f"{label}: leaves whose gradient stays below {zero} of the largest on both "
              f"sides (exactly 0 in the model's math): {zeros or 'none'}")
    (lk, lp), (nk, np_) = gap["losses"], gap["norms"]
    a, b = names
    print(f"{label}: loss {a} {lk:.7f} {b} {lp:.7f} "
          f"(rel {gap['loss']:.2e}, tol {GRAD_TOL['loss']}); grad norm {a} "
          f"{nk:.6f} {b} {np_:.6f} (rel {gap['norm']:.2e}, tol {GRAD_TOL['norm']}); "
          f"worst leaf max|diff| / max|grad| {gap['leaf']:.2e} at {gap['leaf_name']} (tol "
          f"{GRAD_TOL['leaf']}); {len(gp)} leaves")
    if not (all(gap[k] <= GRAD_TOL[k] for k in GRAD_TOL) and math.isfinite(nk)):
        _fail(f"{label}: the {a} path's loss or gradients disagree with the {b} path's")


def train_grad_phase(torch, dev, cfg, label, shape):
    """``cfg`` in fp32: bundle.loss and the gradient of every leaf at batch x
    seq ``shape`` through the hand kernels (the forwards twice a layer under
    remat, the backwards once) and through the plain path (oracle attention
    and scan), on one set of weights."""
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.training.train_loop import to_device, value_and_grad

    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    b, s = shape
    kernel = registry.build(cfg, max_seq=s, device=dev)
    plain = registry.build(dataclasses.replace(cfg, attention_impl="oracle"), max_seq=s,
                           device=dev)
    model = kernel.init(torch.Generator(device=dev).manual_seed(0))
    batch = to_device(next(pipeline.batches(cfg, InputShape("train", s, b, "train"))), dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    t0 = time.perf_counter()
    lk, _, gk = value_and_grad(kernel, model, batch)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = _train_counts()
    t0 = time.perf_counter()
    lp, _, gp = value_and_grad(plain, model, batch)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    plain_launches = tuple(a - b for a, b in zip(_train_counts(), launches))
    want = _train_want(cfg, 1)
    _gate_grads(torch, f"train-grad {label} fp32 B {b} x S {s}", (lk, gk), (lp, gp))
    print(f"train-grad {label} fp32: loss + grads {t_kernel:.2f} s kernel path, {t_plain:.2f} s "
          f"plain path; launches {COUNTS} {launches} (expected {want}; plain path "
          f"{plain_launches}); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if launches != want or any(plain_launches):
        _fail(f"train-grad {label}: launches {launches} / {plain_launches}, expected {want} / "
              f"zeros")
    del model, gk, gp
    _free(torch)


def train_phase(torch, dev, cfg, label, run, *, steps=TRAIN_STEPS, before=None,
                shape=TRAIN_SHAPE):
    """``steps`` bf16 optimizer steps of ``cfg`` at batch x seq ``shape``, made
    by ``run()`` (``launch/train.py``: its main, or its ``train`` on a bundle
    of ``cfg``), with exact launch counts (each attention and Mamba layer's
    forward 2 a step under remat, its backward kernels once), falling finite
    losses, ms per step, tokens/s and peak memory (``before``: an earlier
    run's, printed beside); then one more step traced, its busy share
    against the run's mean step after step 1 (the launcher's steps, each
    with its batch's draw and copy).  Returns the run's
    launches (``COUNTS``), its steady seconds a step and the device bytes
    that the trained parameters, their AdamW state and a batch hold (what
    the card holds beyond what it held before the run)."""
    import numpy as np
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step, param_tree, to_device

    b, s = shape
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()                              # the training path starts here
    res = run()
    launches = _train_counts()                         # read just after it
    peak = torch.cuda.max_memory_allocated()
    want = _train_want(cfg, steps)
    steady = float(np.mean(res.step_s[1:]))
    was = "" if before is None else (f" (before the in-place update: {before['step_ms']} ms a "
                                     f"step, peak {before['peak_gb']} GB)")
    print(f"train {label} bf16 B {b} x S {s}, {steps} steps through launch/train.py: "
          f"losses {[round(x, 4) for x in res.losses]}")
    print(f"train {label}: ms per step {[round(x * 1e3, 1) for x in res.step_s]}; after step 1 "
          f"{steady * 1e3:.1f} ms a step, {b * s / steady:.0f} tokens/s ({res.tokens_per_s:.0f} "
          f"tokens/s over all {steps} steps, the launcher's figure); peak memory "
          f"{peak / 1e9:.2f} GB{was}; launches {COUNTS} {launches} (expected {want})")
    if not np.isfinite(res.losses).all() or not res.losses[-1] < res.losses[0]:
        _fail(f"train {label}: losses {res.losses} are not finite or do not fall")
    if launches != want:
        _fail(f"train {label}: launches {launches} != {want}")

    bundle = registry.build(cfg, max_seq=s, device=dev)
    params = res.final_params
    del res
    _free(torch)
    opt_state = init_opt_state(param_tree(params))
    step = make_train_step(bundle, OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=steps))
    data = pipeline.batches(bundle.cfg, InputShape("train", s, b, "train"), seed=1)
    batch = to_device(next(data), dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    busy = _profile_call(torch, steady, lambda: step(params, opt_state, batch),
                         f"{label} train step", top=12,
                         also=("flash_fwd", "bwd_dq", "bwd_dkdv", "ssm_kernel", "ssm_bwd"))
    del params, opt_state, batch
    _free(torch)
    return launches, {"step_s": steady, "held": held, "busy": busy, "peak": peak}


def granite_train_phase(torch, dev):
    """10 bf16 steps of full-width granite-3-2b through ``python -m
    repro_torch.launch.train``'s main at its defaults."""
    from repro_torch.config import get_config
    from repro_torch.launch import train as launcher

    b, s = TRAIN_SHAPE
    return train_phase(torch, dev, get_config(ARCH), ARCH, lambda: launcher.main(
        ["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(b), "--seq", str(s),
         "--device", dev.type]), before=GRANITE_TRAIN_BEFORE)


def hybrid_train_phase(torch, dev):
    """HYBRID_TRAIN_STEPS bf16 steps of full-width Jamba cut to two layers,
    through ``launch/train.py``'s ``train`` with the launcher's optimizer
    settings on a bundle of the cut config (the launcher's ``--layers`` cuts
    only ``--smoke`` configs)."""
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launcher
    from repro_torch.models import registry
    from repro_torch.training.optimizer import OptimizerConfig

    cfg = hybrid_train_cfg()
    b, s = TRAIN_SHAPE
    steps = HYBRID_TRAIN_STEPS

    def run():
        bundle = registry.build(cfg, max_seq=s, device=dev)
        data = pipeline.batches(cfg, InputShape("cli", s, b, "train"))
        return launcher.train(bundle, data, steps=steps, opt_cfg=OptimizerConfig(
            lr=3e-3, warmup_steps=steps // 10, total_steps=steps))

    print(f"train {HYBRID} x{HYBRID_TRAIN_LAYERS} layers ({cfg.layer_pattern}): "
          f"{cfg.param_count() / 1e9:.3f} B parameters")
    return train_phase(torch, dev, cfg, f"{HYBRID} x{HYBRID_TRAIN_LAYERS}", run, steps=steps)


def forecaster_train_phase(torch, dev):
    """The forecaster's trainer: FORECASTER_TRAIN_STEPS steps of
    make_train_step on the card and on the CPU from one set of weights and
    batches (losses within SMOKE_TRAIN_TOL), then train_forecaster on the
    card with its flash launches counted.  Returns (forward, backward)
    launches of that run."""
    import numpy as np
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.learn import dataset
    from repro_torch.learn import forecaster as fc
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step, param_tree, to_device

    cfg, feat = fc.model_config(), fc.FeatureConfig()
    t0 = time.perf_counter()
    examples = dataset.build_examples(dataset.training_traces(), feat)
    data = list(dataset.batches(examples, FORECASTER_TRAIN_B, steps=FORECASTER_TRAIN_STEPS))
    print(f"forecaster-train: {len(examples['y'])} examples of the training traces, built in "
          f"{time.perf_counter() - t0:.2f} s")
    host, card = fc.make_bundle(cfg, feat, device="cpu"), fc.make_bundle(cfg, feat, device=dev)
    p_host = host.init(torch.Generator().manual_seed(0))
    p_card = fc.forecaster_from_state(p_host.state_dict(), cfg, feat, device=dev)
    opt = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=FORECASTER_TRAIN_STEPS,
                          weight_decay=0.01)
    steps = (make_train_step(host, opt), make_train_step(card, opt))
    states = (init_opt_state(param_tree(p_host)), init_opt_state(param_tree(p_card)))
    worst = 0.0
    for batch in data:
        _, sh, mh = steps[0](p_host, states[0], to_device(batch, torch.device("cpu")))
        _, sc, mc = steps[1](p_card, states[1], to_device(batch, dev))
        states = (sh, sc)
        worst = max(worst, abs(float(mc["loss"]) - float(mh["loss"]))
                    / (1.0 + abs(float(mh["loss"]))))
    print(f"forecaster-train card vs CPU, {len(data)} steps of B {FORECASTER_TRAIN_B}: last "
          f"loss card {float(mc['loss']):.7f} CPU {float(mh['loss']):.7f}; worst step "
          f"|diff| / (1 + |loss|) {worst:.2e} tol={SMOKE_TRAIN_TOL} "
          f"{'ok' if worst <= SMOKE_TRAIN_TOL else 'FAIL'}")
    if worst > SMOKE_TRAIN_TOL:
        _fail("forecaster-train: the card's losses disagree with the CPU's")
    kf.launches = kf.bwd_launches = 0                 # the trainer's path starts here
    params, res, _, _ = fc.train_forecaster(iter(data), steps=len(data), log_every=0,
                                            log_fn=None, device=dev)
    launches = (kf.launches, kf.bwd_launches)         # read just after it
    want = (cfg.num_layers * len(data), kf.BWD_KERNELS * cfg.num_layers * len(data))
    print(f"forecaster-train train_forecaster on the card: losses "
          f"{[round(x, 4) for x in res.losses]}; {np.mean(res.step_s[1:]) * 1e3:.2f} ms a step "
          f"after step 1; launches flash forward, backward kernels {launches} (expected {want})")
    if launches != want or not np.isfinite(res.losses).all():
        _fail(f"forecaster-train: launches {launches} != {want} or a loss is not finite")
    return launches


def smoke_train_phase(torch, dev):
    """Two train steps each of SMOKE whisper-large-v3, internvl2-1b and
    jamba-v0.1-52b (pattern AM: attention, MoE and the scan train), on the
    card and on the CPU from one set of fp32 weights and batches: the losses
    within SMOKE_TRAIN_TOL, the launches exact.  Returns SMOKE jamba's
    launches (``COUNTS``)."""
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step, param_tree, to_device

    b, s = SMOKE_TRAIN_SHAPE
    counts = {}
    for arch in (ENCDEC, VISION, HYBRID):
        host = registry.build_arch(arch, smoke=True, max_seq=s, device="cpu")
        card = registry.build_arch(arch, smoke=True, max_seq=s, device=dev)
        p_host = host.init(torch.Generator().manual_seed(0))
        p_card = card.empty()
        p_card.load_state_dict({k: v.to(dev, copy=True) for k, v in p_host.state_dict().items()},
                               assign=True)
        cfg = host.cfg
        opt = OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=2)
        steps = (make_train_step(host, opt), make_train_step(card, opt))
        states = (init_opt_state(param_tree(p_host)), init_opt_state(param_tree(p_card)))
        it = pipeline.batches(cfg, InputShape("train", s, b, "train"))
        _reset_train_counts()
        for i in range(2):
            batch = next(it)
            _, sh, mh = steps[0](p_host, states[0], to_device(batch, torch.device("cpu")))
            _, sc, mc = steps[1](p_card, states[1], to_device(batch, dev))
            states = (sh, sc)
            lh, lc = float(mh["loss"]), float(mc["loss"])
            ok = abs(lc - lh) <= SMOKE_TRAIN_TOL * (1.0 + abs(lh))
            print(f"smoke-train {arch} SMOKE step {i}: loss card {lc:.7f} CPU {lh:.7f} "
                  f"tol={SMOKE_TRAIN_TOL} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"smoke-train {arch}: the card's loss disagrees with the CPU's")
        launches = counts[arch] = _train_counts()
        want = _train_want(cfg, 2)
        print(f"smoke-train {arch}: launches {COUNTS} {launches} (expected {want})")
        if launches != want:
            _fail(f"smoke-train {arch}: launches {launches} != {want}")
    return counts[HYBRID]


def lifecycle_phase(torch, dev):
    """SMOKE granite-3-2b trained on the card (8 steps), checkpointed,
    restored into the engine's SnapshotStore and served from it: the served
    weights are the trained ones and the tokens those of the trained model."""
    import numpy as np
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore, generate
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import train

    bundle = registry.build_arch(ARCH, smoke=True, max_seq=32, device=dev)
    data = pipeline.batches(bundle.cfg, InputShape("t", 32, 2, "train"))
    res = train(bundle, data, steps=8, log_every=0, log_fn=None,
                opt_cfg=OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=8))
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "model.npz")
        size = checkpoint.save(ck, res.final_params.state_dict())
        trained, _ = checkpoint.restore(ck)
        store = SnapshotStore(str(Path(tmp) / "snaps"))
        eng = InferenceEngine(ARCH, smoke=True, max_seq=32, batch=1, store=store, device=dev)
        store.save_params(eng.key, {k: torch.from_numpy(v) for k, v in trained.items()})
        breakdown = eng.cold_start(from_snapshot=True)
        same = all(np.array_equal(p.cpu().numpy(), trained[k])
                   for k, p in eng.params.state_dict().items())
        tokens = np.ones((1, 32), np.int32)
        out, _ = eng.serve(tokens, decode_steps=4)
        want, _ = generate(bundle, res.final_params, tokens, decode_steps=4)
        eng.shutdown()
    print(f"lifecycle {ARCH} SMOKE: losses {res.losses[0]:.4f} -> {res.losses[-1]:.4f} in 8 "
          f"steps on the card; checkpoint {size / 2**20:.1f} MB; served from the snapshot "
          f"({breakdown}): weights equal the trained {same}, tokens {out[0].tolist()} "
          f"(trained model {want[0].tolist()})")
    if not (same and np.array_equal(out, want) and res.losses[-1] < res.losses[0]):
        _fail("lifecycle: the served snapshot is not the trained model")


def guard_phase(torch, dev):
    """Differentiating through a CUDA kernel that has no backward raises."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((1, 4, 64), generator=gen, device=dev, requires_grad=True)
    kc = torch.randn((1, 32, 2, 64), generator=gen, device=dev)
    mask = torch.ones((1, 32), dtype=torch.bool, device=dev)
    try:
        ops.decode_attention(q, kc, kc, mask)
    except RuntimeError as e:
        print(f"guard decode_attention with an input that requires grad on the card: "
              f"raised ({e})")
        return
    _fail("guard: decode_attention launched on inputs that require grad")


# --------------------------------------------------------------------------- #
# phases 27-29: the expert-parallel MoE on a one-rank NCCL world, the dry run
# and the roofline (launch/{mesh,specs,dryrun,roofline}.py, sharding.py)
# --------------------------------------------------------------------------- #

# the EP gradient check's B x S: 2048 tokens, the fewest that take the EP path
EP_SHAPE = (1, 2048)
# the dry run's argument bytes against the card's allocation for them
DRYRUN_TOL = 0.01


@contextlib.contextmanager
def _nccl_world():
    """A one-rank NCCL world (a FileStore in a temporary directory), torn
    down on exit: the card's stand-in for a multi-card mesh."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def ep_phase(torch, dev):
    """The two-layer Jamba through the expert-parallel MoE path on a one-rank
    NCCL world (a FileStore in a temporary directory): its fp32 loss and
    gradients at B 1 x S 2048 under ``use_rules(make_rules(...),
    make_host_mesh())`` against the same call with no rules (phase 20's
    tolerances), then one bf16 step through the EP path, with the all-reduce
    bytes it counted."""
    from repro_torch import sharding
    from repro_torch.config import InputShape
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, registry
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import (make_train_step, param_tree, to_device,
                                                 value_and_grad)

    t0 = time.perf_counter()
    b, s = EP_SHAPE
    shape = InputShape("ep", s, b, "train")
    label = f"{HYBRID} x{HYBRID_TRAIN_LAYERS}"
    with _nccl_world():
        mesh = make_host_mesh()
        cfg = dataclasses.replace(hybrid_train_cfg(), dtype="float32", param_dtype="float32")
        rules = sharding.make_rules(cfg, shape, mesh)
        bundle = registry.build(cfg, max_seq=s, device=dev)
        model = bundle.init(torch.Generator(device=dev).manual_seed(0))
        batch = to_device(next(pipeline.batches(cfg, shape)), dev)
        lp, _, gp = value_and_grad(bundle, model, batch)
        moe.allreduce_bytes.update(combine=0, backward=0)
        with sharding.use_rules(rules, mesh):
            le, _, ge = value_and_grad(bundle, model, batch)
        torch.cuda.synchronize()
        counted = dict(moe.allreduce_bytes)

        def norm(g):
            return torch.sqrt(sum(x.double().square().sum() for x in g.values())).item()

        ne, np_ = norm(ge), norm(gp)
        worst, worst_name = max((((ge[k] - gp[k]).abs().max().item()
                                  / max(gp[k].abs().max().item(), 1e-30), k) for k in gp))
        le, lp = le.item(), lp.item()
        print(f"ep {label} fp32 B {b} x S {s} on a (1, 1) NCCL mesh (rules expert="
              f"{rules['expert']!r}): loss EP {le:.7f} single {lp:.7f} (rel "
              f"{abs(le - lp) / abs(lp):.2e}, tol {GRAD_TOL['loss']}); grad norm EP "
              f"{ne:.6f} single {np_:.6f} (rel {abs(ne - np_) / np_:.2e}, tol "
              f"{GRAD_TOL['norm']}); worst leaf {worst:.2e} at {worst_name} (tol "
              f"{GRAD_TOL['leaf']}); all-reduce bytes {counted}")
        if not counted["combine"] or not counted["backward"]:
            _fail(f"ep {label}: the EP path placed no all-reduce ({counted})")
        if not (abs(le - lp) <= GRAD_TOL["loss"] * abs(lp)
                and abs(ne - np_) <= GRAD_TOL["norm"] * np_
                and worst <= GRAD_TOL["leaf"] and math.isfinite(ne)):
            _fail(f"ep {label}: the EP path's loss or gradients disagree with the "
                  f"single-device path's")
        del model, gp, ge, batch
        _free(torch)

        cfg = hybrid_train_cfg()
        bundle = registry.build(cfg, max_seq=s, device=dev)
        model = bundle.init(torch.Generator(device=dev).manual_seed(0))
        opt_state = init_opt_state(param_tree(model))
        step = make_train_step(bundle, OptimizerConfig(lr=3e-3, warmup_steps=1,
                                                       total_steps=1))
        batch = to_device(next(pipeline.batches(cfg, shape)), dev)
        moe.allreduce_bytes.update(combine=0, backward=0)
        t1 = time.perf_counter()
        with sharding.use_rules(sharding.make_rules(cfg, shape, mesh), mesh):
            _, _, metrics = step(model, opt_state, batch)
        loss = metrics["total_loss"].item()
        step_s = time.perf_counter() - t1
        print(f"ep {label} bf16: one step through the EP path at B {b} x S {s}: loss "
              f"{loss:.4f}, {step_s * 1e3:.1f} ms (the first: allocator and NCCL "
              f"warm-up included); all-reduce bytes counted {dict(moe.allreduce_bytes)}")
        if not math.isfinite(loss) or not moe.allreduce_bytes["combine"]:
            _fail(f"ep {label} bf16 step: loss {loss} or no combine all-reduce")
        del model, opt_state, batch
        _free(torch)
    print(f"phase ep: {time.perf_counter() - t0:.1f} s")


def dryrun_phase(torch, granite_held, hybrid_held):
    """The dry run: the spec pass of every (architecture, shape) on both
    production meshes (80 records: 14 skipped, 0 errors); then the meta pass
    of full-width granite-3-2b and of the two-layer Jamba training at B 8 x S
    256 on one chip, with no kernel launched; granite's argument bytes held
    within DRYRUN_TOL of what its trained parameters, AdamW state and batch
    held on the card (``granite_held``; the Jamba's printed beside its own)."""
    from repro_torch.config import ARCH_IDS, SHAPES, InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import one_chip

    t0 = time.perf_counter()
    results, n = dryrun.run_all(ARCH_IDS, list(SHAPES), [False, True], do_compile=False,
                                echo=False)
    spec_s = time.perf_counter() - t0
    print(f"dryrun spec pass: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors / "
          f"{len(results)} pairs in {spec_s:.2f} s")
    if (len(results), n["ok"], n["skipped"], n["error"]) != (80, 66, 14, 0):
        _fail(f"dryrun spec pass: {n} over {len(results)} pairs, expected 66 / 14 / 0 of 80")
    b, s = TRAIN_SHAPE
    shape = InputShape("train", s, b, "train")
    before = _train_counts()
    for label, cfg, held in ((ARCH, get_config(ARCH), granite_held),
                             (f"{HYBRID} x{HYBRID_TRAIN_LAYERS}", hybrid_train_cfg(),
                              hybrid_held)):
        rec = dryrun.dry_run(cfg, shape, one_chip())
        arg = rec["bytes_per_device"]["argument"]
        rel = abs(held - arg) / arg
        print(f"dryrun {label} train B {b} x S {s} on one chip: meta pass {rec['lower_s']} s, "
              f"argument bytes {arg} ({arg / 1e9:.3f} GB) against {held} held on the card "
              f"after its training phase (rel {rel:.2e}, tol {DRYRUN_TOL} for {ARCH})")
        if label == ARCH and not rel <= DRYRUN_TOL:
            _fail(f"dryrun {label}: argument bytes {arg} vs {held} on the card")
    if _train_counts() != before:
        _fail(f"dryrun: the meta passes launched kernels ({before} -> {_train_counts()})")
    print(f"phase dryrun: {time.perf_counter() - t0:.1f} s")


def roofline_phase(torch, measured):
    """The H100 roofline (``launch/roofline.py``: the meta pass's FLOPs and
    bytes, the hand kernels' work counted analytically) of granite-3-2b's
    train step at B 8 x S 256, its prefill of MAX_SEQ tokens and the
    two-layer Jamba's train step, each held at or below the time the earlier
    phases measured for the same work (``measured``: label -> seconds)."""
    from repro_torch.config import InputShape, get_config
    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    b, s = TRAIN_SHAPE
    train = InputShape("train", s, b, "train")
    pairs = [(f"{ARCH} train", get_config(ARCH), train),
             (f"{ARCH} prefill", get_config(ARCH), InputShape("prefill", MAX_SEQ, 1, "prefill")),
             (f"{HYBRID} x{HYBRID_TRAIN_LAYERS} train", hybrid_train_cfg(), train)]
    for label, cfg, shape in pairs:
        rec = roofline.analyze(cfg, shape)
        got = measured[label]
        print(f"roofline {label} (B {shape.global_batch} x S {shape.seq_len}) on one H100: "
              f"bound {rec['bound_s'] * 1e3:.3f} ms ({rec['dominant']}: compute "
              f"{rec['compute_s'] * 1e3:.3f} ms, memory {rec['memory_s'] * 1e3:.3f} ms), "
              f"FLOPs {rec['flops_per_device']:.4e} (by dtype {rec['flops_by_dtype']}), "
              f"bytes {rec['bytes_per_device']:.4e} (the AdamW update's "
              f"{rec['update_bytes_per_device']:.4e}), model FLOPs {rec['model_flops_global']:.4e}; "
              f"measured {got * 1e3:.3f} ms; bound / measured {rec['bound_s'] / got:.3f}; "
              f"counted in {rec['measure_s']} s")
        if not rec["bound_s"] <= got:
            _fail(f"roofline {label}: bound {rec['bound_s']} s above the measured {got} s")
    print(f"phase roofline: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------- #
# phase 30: the GSPMD path (sharding.logical as DTensor placements, the hand
# kernels through local_map) on a one-rank NCCL world
# --------------------------------------------------------------------------- #

GSPMD_GRAD_SHAPE = (1, 256)    # phase a's B x S (fp32)
GSPMD_PROMPT = 512             # phase c's prompt, the engine's max_seq
# phase c: the DTensor path runs prefill's ops on the same bf16 operands; held
# at the attention kernels' bf16 tolerance, of the logits' largest magnitude
GSPMD_PREFILL_TOL = 5e-2


def _gspmd_place(model, batch, rules, mesh):
    """``model``'s parameters (in place) and ``batch`` as DTensors placed by
    ``launch/specs.py``'s specs."""
    from repro_torch.launch import specs

    specs.distribute_params(model, rules, mesh)
    return specs.distribute_batch(batch, rules, mesh)


def _second_call_ms(torch, call):
    """The host-clock ms of the second of two ``call()``s (the first warms)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _grad_gap(torch, got, want, skip=()):
    """(loss, norm, largest leaf) gaps of ``got`` = (loss, grads) against
    plain ``want``: relative, and the largest absolute difference.  ``got``'s
    leaves may be DTensors (taken whole) or lie on another device; a leaf in
    ``skip`` counts in the norms only."""
    (lg, gg), (lw, gw) = got, want
    gg = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).to(gw[k].device)
          for k, v in gg.items()}

    def norm(g):
        return torch.sqrt(sum(x.double().square().sum() for x in g.values())).item()

    worst, name, diff = 0.0, "", 0.0
    for k in gw:
        if k in skip:
            continue
        d = (gg[k].float() - gw[k].float()).abs().max().item()
        r = d / max(gw[k].abs().max().item(), 1e-30)
        diff = max(diff, d)
        if r >= worst:
            worst, name = r, k
    lg, lw, ng, nw = float(lg), float(lw), norm(gg), norm(gw)
    return {"loss": abs(lg - lw) / abs(lw), "norm": abs(ng - nw) / nw, "leaf": worst,
            "leaf_name": name, "max_abs_diff": max(diff, abs(lg - lw)), "losses": (lg, lw),
            "norms": (ng, nw)}


def gspmd_phase(torch, dev, granite_step_s):
    """Phase 30: the GSPMD path on a one-rank NCCL world (a FileStore in a
    temporary directory) with a (1, 1) ("data", "model") mesh: the
    parameters and batches are DTensors, so DTensor's dispatch, the models'
    ``logical`` redistributions and the kernels' ``local_map`` routes run.
    c: full-width granite-3-2b's bf16 512-token prefill, logits and caches
    against the plain prefill on the same weights (40 flash launches);
    a: full-width granite in fp32 at B 1 x S 256, the loss and every
    gradient against phase 20's path on the same weights (phase 20's
    tolerances; bit-equal expected, the largest difference printed);
    b: one bf16 train step of full-width granite at B 8 x S 256 through
    ``make_train_step``, launches equal to phase 21's a step, its ms beside
    phase 21's (DTensor's host cost, no gate);
    d: SMOKE jamba (AM) in fp32, loss and gradients on the card through the
    DTensor path against the CPU's plain path, the scan and its backward
    counted through ``local_map``.  Returns the numbers printed."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding
    from repro_torch.config import InputShape, get_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import specs
    from repro_torch.models import registry
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import (make_train_step, param_tree, to_device,
                                                 value_and_grad)

    t0 = time.perf_counter()
    out = {}
    with _nccl_world():
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))

        # c: bf16 prefill
        cfg = get_config(ARCH)
        shape = InputShape("prefill", GSPMD_PROMPT, 1, "prefill")
        bundle = registry.build(cfg, shape, max_seq=GSPMD_PROMPT, device=dev)
        model = bundle.init(torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, GSPMD_PROMPT), device=dev,
                                         generator=gen, dtype=torch.int32)}
        with torch.no_grad():
            want, want_caches, _ = bundle.prefill(model, batch)
            plain_ms = _second_call_ms(torch, lambda: bundle.prefill(model, batch))
        rules = sharding.make_rules(cfg, shape, mesh)
        placed = _gspmd_place(model, batch, rules, mesh)
        kf.launches = 0
        with sharding.use_rules(rules, mesh), torch.no_grad():
            got, got_caches, pos = bundle.prefill(model, placed)
            got = got.full_tensor()
            flash = kf.launches
            dtensor_ms = _second_call_ms(torch, lambda: bundle.prefill(model, placed))
        diff = (got.float() - want.float()).abs().max().item()
        cache_diff = max((g[k].full_tensor().float() - w[k].float()).abs().max().item()
                         for g, w in zip(got_caches, want_caches) for k in w)
        scale = want.float().abs().max().item()
        out["prefill"] = {"max_abs_diff": diff, "cache_max_abs_diff": cache_diff,
                          "ms": dtensor_ms, "plain_ms": plain_ms, "flash": flash}
        print(f"gspmd c {ARCH} bf16 prefill of {GSPMD_PROMPT} tokens on a (1, 1) NCCL mesh "
              f"through DTensor: logits max|diff| {diff:.3e} against the plain prefill "
              f"(max|logit| {scale:.3f}, tol {GSPMD_PREFILL_TOL} of it), caches max|diff| "
              f"{cache_diff:.3e}; {dtensor_ms:.1f} ms a prefill through DTensor, "
              f"{plain_ms:.1f} plain (each the second of two calls); flash launches "
              f"{flash} (expected {cfg.num_layers}); next position {pos}")
        if not (diff <= GSPMD_PREFILL_TOL * scale and cache_diff <= GSPMD_PREFILL_TOL
                * max(w[k].float().abs().max().item() for w in want_caches for k in w)
                and math.isfinite(diff)):
            _fail("gspmd c: the DTensor prefill disagrees with the plain prefill")
        if flash != cfg.num_layers:
            _fail(f"gspmd c: {flash} flash launches, expected {cfg.num_layers}")
        del model, placed, want, got, want_caches, got_caches
        _free(torch)

        # a: fp32 loss and gradients
        cfg = dataclasses.replace(get_config(ARCH), dtype="float32", param_dtype="float32")
        b, s = GSPMD_GRAD_SHAPE
        shape = InputShape("train", s, b, "train")
        bundle = registry.build(cfg, max_seq=s, device=dev)
        model = bundle.init(torch.Generator(device=dev).manual_seed(0))
        batch = to_device(next(pipeline.batches(cfg, shape)), dev)
        lp, _, gp = value_and_grad(bundle, model, batch)
        rules = sharding.make_rules(cfg, shape, mesh)
        placed = _gspmd_place(model, batch, rules, mesh)
        _reset_train_counts()
        with sharding.use_rules(rules, mesh):
            ld, _, gd = value_and_grad(bundle, model, placed)
        torch.cuda.synchronize()
        launches, want = _train_counts(), _train_want(cfg, 1)
        gap = _grad_gap(torch, (ld, gd), (lp, gp))
        out["grad"] = gap
        print(f"gspmd a {ARCH} fp32 B {b} x S {s}: loss DTensor {gap['losses'][0]:.7f} "
              f"plain {gap['losses'][1]:.7f} (rel {gap['loss']:.2e}, tol "
              f"{GRAD_TOL['loss']}); grad norm rel {gap['norm']:.2e} (tol "
              f"{GRAD_TOL['norm']}); worst leaf {gap['leaf']:.2e} at {gap['leaf_name']} "
              f"(tol {GRAD_TOL['leaf']}); largest difference of the loss and every "
              f"gradient {gap['max_abs_diff']:.3e} ({'bit-equal' if gap['max_abs_diff'] == 0 else 'not bit-equal'}); "
              f"launches {COUNTS} {launches} (expected {want}); {len(gp)} leaves")
        if not (gap["loss"] <= GRAD_TOL["loss"] and gap["norm"] <= GRAD_TOL["norm"]
                and gap["leaf"] <= GRAD_TOL["leaf"]):
            _fail("gspmd a: the DTensor path's loss or gradients disagree with phase 20's")
        if launches != want:
            _fail(f"gspmd a: launches {launches} != {want}")
        del model, placed, gp, gd
        _free(torch)

        # b: one bf16 train step at phase 21's shape
        cfg = get_config(ARCH)
        b, s = TRAIN_SHAPE
        shape = InputShape("train", s, b, "train")
        bundle = registry.build(cfg, max_seq=s, device=dev)
        model = bundle.init(torch.Generator(device=dev).manual_seed(0))
        rules = sharding.make_rules(cfg, shape, mesh)
        data = pipeline.batches(cfg, shape, seed=1)
        batches = [_gspmd_place(model, to_device(next(data), dev), rules, mesh),
                   specs.distribute_batch(to_device(next(data), dev), rules, mesh)]
        opt_state = init_opt_state(param_tree(model))
        step = make_train_step(bundle, OptimizerConfig(lr=3e-3, warmup_steps=1,
                                                       total_steps=2))
        torch.cuda.reset_peak_memory_stats()
        with sharding.use_rules(rules, mesh):
            _, opt_state, m0 = step(model, opt_state, batches[0])   # warm-up
            torch.cuda.synchronize()
            _reset_train_counts()
            t1 = time.perf_counter()
            _, opt_state, m1 = step(model, opt_state, batches[1])
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        launches, want = _train_counts(), _train_want(cfg, 1)
        losses = (float(m0["loss"]), float(m1["loss"]))
        out["step"] = {"ms": step_s * 1e3, "launches": launches,
                       "phase21_ms": None if granite_step_s is None else granite_step_s * 1e3}
        was = ("not run" if granite_step_s is None
               else f"{granite_step_s * 1e3:.1f} ms a step (phase 21, after its step 1)")
        print(f"gspmd b {ARCH} bf16 B {b} x S {s}: one train step through DTensor "
              f"{step_s * 1e3:.1f} ms after a warm-up step, beside {was}; losses {losses}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
              f"{COUNTS} {launches} (expected {want}, phase 21's a step)")
        if launches != want or not all(map(math.isfinite, losses)):
            _fail(f"gspmd b: launches {launches} != {want} or losses {losses}")
        del model, opt_state, batches
        _free(torch)

        # d: SMOKE jamba (AM), card through DTensor vs the CPU
        b, s = SMOKE_TRAIN_SHAPE
        host = registry.build_arch(HYBRID, smoke=True, max_seq=s, device="cpu")
        card = registry.build_arch(HYBRID, smoke=True, max_seq=s, device=dev)
        cfg = host.cfg
        shape = InputShape("train", s, b, "train")
        p_host = host.init(torch.Generator().manual_seed(0))
        p_card = card.empty()
        p_card.load_state_dict({k: v.to(dev, copy=True)
                                for k, v in p_host.state_dict().items()}, assign=True)
        batch = next(pipeline.batches(cfg, shape))
        lh, _, gh = value_and_grad(host, p_host, to_device(batch, torch.device("cpu")))
        rules = sharding.make_rules(cfg, shape, mesh)
        placed = _gspmd_place(p_card, to_device(batch, dev), rules, mesh)
        _reset_train_counts()
        with sharding.use_rules(rules, mesh):
            lc, _, gc = value_and_grad(card, p_card, placed)
        torch.cuda.synchronize()
        launches, want = _train_counts(), _train_want(cfg, 1)
        gap = _grad_gap(torch, (lc, gc), (lh, {k: v.to(dev) for k, v in gh.items()}))
        out["smoke"] = gap
        print(f"gspmd d {HYBRID} SMOKE ({cfg.layer_pattern}) fp32 B {b} x S {s}: loss card "
              f"DTensor {gap['losses'][0]:.7f} CPU {gap['losses'][1]:.7f} (tol "
              f"{SMOKE_TRAIN_TOL}); worst leaf {gap['leaf']:.2e} at {gap['leaf_name']} (tol "
              f"{GRAD_TOL['leaf']}); launches {COUNTS} {launches} (expected {want})")
        lg, lw = gap["losses"]
        if not (abs(lg - lw) <= SMOKE_TRAIN_TOL * (1.0 + abs(lw))
                and gap["leaf"] <= GRAD_TOL["leaf"]):
            _fail("gspmd d: the card's DTensor loss or gradients disagree with the CPU's")
        if launches != want or not launches[2]:
            _fail(f"gspmd d: launches {launches} != {want}")
        del p_card, placed, gc
        _free(torch)
    print(f"phase gspmd: {time.perf_counter() - t0:.1f} s")
    return out


# phase 31: decode under the decode rules.  a: granite's bf16 decode from a
# 496-token prefill at max_seq 512 (the writes land inside the cache); b: the
# split softmax at granite's and internvl2's (G 7) decode shapes, the cache's
# rows cut into 2 and 4 slices, the first SPLIT_VALID rows valid (a slice of
# 256 and two of 128 wholly masked)
GSPMD_DECODE_PROMPT = 496
SPLIT_SHAPES, SPLIT_PARTS, SPLIT_VALID = ("granite", "internvl2"), (2, 4), 200
SPLIT_STATS_TOL = 1e-5          # the statistics' fp32 numbers, kernel vs plain


def _split_softmax(torch, q, k, v, mask, parts):
    """The hand kernel's statistics on ``parts`` contiguous row slices and
    their merge (``ops.combine_partials``): what each rank of a world that
    splits a cache's rows computes, in one process.  Returns the merge, each
    slice's (out, m, l) and the slices."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import ops

    n = k.shape[1] // parts
    cut = [(k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], mask[:, i * n:(i + 1) * n])
           for i in range(parts)]
    stats = [kd.decode_attention_hopper(q, ks, vs, ms, stats=True) for ks, vs, ms in cut]
    merged = ops.combine_partials(*(torch.stack(t) for t in zip(*stats)), dtype=q.dtype)
    return merged, stats, cut


def gspmd_decode_phase(torch, dev):
    """Phase 31: decode under the decode rules.
    a: on a one-rank NCCL world with a (1, 1) ("data", "model") mesh,
    full-width granite-3-2b in bf16: a 496-token prefill at max_seq 512,
    the caches placed by ``specs.distribute_caches``, then DECODE_STEPS
    decode steps through DTensor (the token by ``distribute_token``): each
    step's logits and every cache leaf bit-equal to the plain
    ``decode_step`` from the same prefill caches, the decode launches equal
    (40 a step); the ms a token through DTensor beside the plain ms a token
    (DTensor's host cost, no gate).
    b: the split softmax in one process, at granite's and internvl2's (G 7)
    decode shapes over a 512-row cache, fp32 and bf16: the hand kernel with
    ``stats=True`` on 2 and 4 contiguous row slices (some wholly masked) and
    ``ops.combine_partials``, against the whole-cache kernel call and the
    plain version (the attention gates), each slice's (out, m, l) against
    the plain version's (SPLIT_STATS_TOL; m = -1e30 and l = the row count
    exactly on a masked slice); the statistics instantiation timed beside
    the serving one.  Returns (a's decode launches, b's split-path
    launches, b's numbers)."""
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding
    from repro_torch.config import InputShape, get_config
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels.ref import NEG_INF
    from repro_torch.launch import roofline, specs
    from repro_torch.models import registry

    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    shape = InputShape("decode", MAX_SEQ, 1, "decode")
    bundle = registry.build(cfg, shape, max_seq=MAX_SEQ, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, GSPMD_DECODE_PROMPT), device=dev,
                           generator=gen, dtype=torch.int32)
    fed = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, 1), device=dev, generator=gen,
                        dtype=torch.int32)

    def steps(caches, pos, token=lambda t: t):
        logits = []
        for i in range(DECODE_STEPS):
            lg, caches = bundle.decode_step(model, caches, token(fed[i]), pos + i)
            logits.append(lg)
        torch.cuda.synchronize()
        return logits, caches

    def timed(run):
        t1 = time.perf_counter()
        run()
        return (time.perf_counter() - t1) * 1e3 / DECODE_STEPS

    with torch.no_grad():
        _, prefilled, pos = bundle.prefill(model, {"tokens": prompt})
        kd.launches = 0
        want, want_caches = steps(prefilled, pos)
        plain_launches = kd.launches
        plain_ms = timed(lambda: steps(prefilled, pos))
    with _nccl_world():
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rules = sharding.make_rules(cfg, shape, mesh)
        specs.distribute_params(model, rules, mesh)
        placed = specs.distribute_caches(prefilled, rules, mesh)
        placements = [t.placements for c in placed for t in c.values()]

        def token(t):
            return specs.distribute_token(t, rules, mesh)

        with sharding.use_rules(rules, mesh), torch.no_grad():
            kd.launches = 0
            got, got_caches = steps(placed, pos, token)
            launches = kd.launches
            dtensor_ms = timed(lambda: steps(placed, pos, token))
        logit_diff = max((g.full_tensor().float() - w.float()).abs().max().item()
                         for g, w in zip(got, want))
        cache_diff = max((g[n].full_tensor().float() - w[n].float()).abs().max().item()
                         for g, w in zip(got_caches, want_caches) for n in w)
        kept = [t.placements for c in got_caches for t in c.values()] == placements
    print(f"gspmd-decode a {ARCH} bf16 on a (1, 1) NCCL mesh: {GSPMD_DECODE_PROMPT}-token "
          f"prefill at max_seq {MAX_SEQ}, then {DECODE_STEPS} decode steps through DTensor "
          f"(caches by distribute_caches, token by distribute_token): logits max|diff| "
          f"{logit_diff:.3e}, caches max|diff| {cache_diff:.3e} against the plain decode "
          f"(bit-equal expected); cache placements kept {kept}; decode launches {launches} "
          f"(plain {plain_launches}, expected {cfg.num_layers * DECODE_STEPS}); "
          f"{dtensor_ms:.2f} ms a token through DTensor, {plain_ms:.2f} plain "
          f"({dtensor_ms / plain_ms:.2f}x; host clock, the second of two runs)")
    if logit_diff != 0 or cache_diff != 0 or not kept:
        _fail("gspmd-decode a: the DTensor decode is not bit-equal to the plain decode, "
              "or a cache left its placements")
    if not launches == plain_launches == cfg.num_layers * DECODE_STEPS:
        _fail(f"gspmd-decode a: decode launches {launches}, plain {plain_launches}")
    del model, prefilled, placed, want_caches, got_caches
    _free(torch)

    # b: the split softmax on the card
    gen = torch.Generator(device=dev).manual_seed(6)
    split_launches, out = 0, {}
    for name in SPLIT_SHAPES:
        hq, hkv, d = ATTN_SHAPES[name]
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn((1, hq, d), generator=gen, device=dev).to(tdt)
            k, v = (torch.randn((1, MAX_SEQ, hkv, d), generator=gen, device=dev).to(tdt)
                    for _ in range(2))
            mask = (torch.arange(MAX_SEQ, device=dev) < SPLIT_VALID)[None].contiguous()
            whole = kd.decode_attention_hopper(q, k, v, mask)
            plain = kd.decode_attention_plain(q, k, v, mask)
            for parts in SPLIT_PARTS:
                before = kd.launches
                merged, stats, cut = _split_softmax(torch, q, k, v, mask, parts)
                split_launches += kd.launches - before
                torch.cuda.synchronize()
                err_whole, ok_whole = _close(merged, whole, KERNEL_TOL[dtype])
                err_plain, ok_plain = _close(merged, plain, KERNEL_TOL[dtype])
                err_stats, ok_stats, masked_ok = 0.0, True, True
                for (ks, vs, ms), got_s in zip(cut, stats):
                    want_s = kd.decode_attention_plain(q, ks, vs, ms, stats=True)
                    for g, w in zip(got_s, want_s):
                        e, ok = _close(g, w, SPLIT_STATS_TOL)
                        err_stats, ok_stats = max(err_stats, e), ok_stats and ok
                    if not ms.any():
                        masked_ok &= bool((got_s[1] == NEG_INF).all()
                                          and (got_s[2] == ks.shape[1]).all())
                n_masked = sum(not ms.any() for _, _, ms in cut)
                print(f"gspmd-decode b {name} {hq}/{hkv} D={d} {dtype} S {MAX_SEQ} in {parts} "
                      f"slices ({n_masked} wholly masked, {SPLIT_VALID} valid rows): merge vs "
                      f"whole-cache kernel {err_whole:.3e}, vs plain {err_plain:.3e} (tol "
                      f"{KERNEL_TOL[dtype]}); statistics vs plain {err_stats:.3e} (tol "
                      f"{SPLIT_STATS_TOL}); masked slices m = -1e30, l = rows {masked_ok}")
                if not (ok_whole and ok_plain and ok_stats and masked_ok and n_masked
                        and torch.isfinite(merged.float()).all()):
                    _fail(f"gspmd-decode b: {name} {dtype} in {parts} slices disagrees")
    # the statistics instantiation timed beside the serving one, at granite's
    # bf16 decode shape over the whole (all-valid) 512-row cache
    hq, hkv, d = ATTN_SHAPES["granite"]
    q = torch.randn((1, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, MAX_SEQ, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    mask = torch.ones((1, MAX_SEQ), dtype=torch.bool, device=dev)
    got = kd.decode_attention_hopper(q, k, v, mask, stats=True)
    want = kd.decode_attention_plain(q, k, v, mask, stats=True)
    torch.cuda.synchronize()
    err = max(_close(g, w, SPLIT_STATS_TOL)[0] for g, w in zip(got, want))
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    out = dict(max_abs_err=err, bound=_bound(roofline.decode_work(
                   1, MAX_SEQ, hq, hkv, d, 2, MAX_SEQ, stats=True)),
               ms=_graph_ms(torch, lambda: kd.decode_attention_hopper(q, k, v, mask, stats=True)),
               launch_ms=_time_ms(torch, lambda: kd.decode_attention_hopper(q, k, v, mask,
                                                                            stats=True)),
               serving_ms=_graph_ms(torch, lambda: kd.decode_attention_hopper(q, k, v, mask)),
               serving_launch_ms=_time_ms(torch, lambda: kd.decode_attention_hopper(q, k, v,
                                                                                    mask)),
               plain_ms=_graph_ms(torch, lambda: kd.decode_attention_plain(q, k, v, mask,
                                                                           stats=True)),
               library_ms=_graph_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, enable_gqa=True)))
    print(f"time decode_attention statistics instantiation bf16 (granite {hq}/{hkv} heads, D "
          f"{d}, S {MAX_SEQ}, all valid), device (graph replay): {out['ms']:.4f} ms "
          f"[{out['launch_ms']:.4f}] beside the serving instantiation {out['serving_ms']:.4f} "
          f"[{out['serving_launch_ms']:.4f}]; plain (stats) {out['plain_ms']:.4f} ms, sdpa "
          f"{out['library_ms']:.4f} ms, bound {out['bound'][0]:.5f} ms ({out['bound'][1]}); "
          f"statistics vs plain {err:.3e}; the split path launched it {split_launches} times")
    print(f"phase gspmd-decode: {time.perf_counter() - t0:.1f} s")
    return launches, split_launches, out


# --------------------------------------------------------------------------- #
# phases 32-36: the four architectures that had not run on the card
# --------------------------------------------------------------------------- #


# (arch, its ATTN_SHAPES key, layers of the fp32 check, layers of the bf16
# serve; None: all): only depth is cut, where the weights would not fit one
# card (fp32 qwen3-moe: 122 GB for 48 layers; arctic: ~27 GB a bf16 layer of
# 35), to the most whole layers that fit (arctic bf16: the fewest with a cache
# across layers).  qwen2.5-14b is served through the InferenceEngine, the
# others through its request loop (engine.generate) on registry.build.  C2
# (restore < cold start) is printed there, not gated: the restore copies
# 29.5 GB over the host link (627 ms at 47 GB/s on an H100 80GB HBM3 at
# 700 W), while the cold start draws the weights from the seed on the card
# (258 ms) and warms up (227 ms): the restore loses, 627 against 484 ms
ARCHS = [("qwen2.5-14b", "qwen2.5", None, None), ("starcoder2-15b", "starcoder2", None, None),
         ("qwen3-moe-30b-a3b", "qwen3-moe", 24, None), ("arctic-480b", "arctic", 1, 2)]
ENGINE_ARCH = "qwen2.5-14b"
MODEL_BATCHES = (1, SERVE_B)   # the fp32 checks: one prompt, and 8 in one call
# fp32 init draws each leaf in its own dtype on the card: no staging copy
INIT_TOL = 0.01
# one full-width qwen3-moe MoE layer in fp32, card against CPU: a token's
# top-k set may differ only where its k-th and (k+1)-th probabilities lie
# within MOE_GAP; elsewhere the outputs agree within MOE_TOL of the largest
MOE_ARCH, MOE_TOKENS, MOE_GAP, MOE_TOL = "qwen3-moe-30b-a3b", 512, 1e-6, 1e-5


def _host_room():
    """MemAvailable and the free bytes of the temporary directory (where a
    snapshot store writes), as one line."""
    import shutil

    avail = next((int(line.split()[1]) * 1024 for line in Path("/proc/meminfo").read_text()
                  .splitlines() if line.startswith("MemAvailable:")), -1)
    tmp = tempfile.gettempdir()
    return (f"host MemAvailable {avail / 1e9:.1f} GB; {tmp} free "
            f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")


def _counts():
    """The serving kernels' launch counters: scan, flash, decode."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks

    return ks.launches, kf.launches, kd.launches


def serve_request(torch, bundle, model, prompt, label, want):
    """One request (the B rows of ``prompt``) through the engine's loop with
    exact launches ``want`` = (scan, flash, decode) and tokens in range;
    prints prefill ms and ms a token.  Returns the launches and the stats."""
    from repro_torch.serving.engine import generate

    c = _counts()
    out, st = generate(bundle, model, prompt, decode_steps=DECODE_STEPS)
    got = tuple(a - b for a, b in zip(_counts(), c))
    b = prompt.shape[0]
    rows = (f", {st.decode_s / st.tokens / b * 1e3:.3f} ms a row's token" if b > 1 else "",
            f", {len(set(map(tuple, out.tolist())))} distinct rows" if b > 1 else "")
    print(f"{label}: prefill {st.prefill_s * 1e3:.2f} ms, decode {st.decode_s * 1e3:.2f} ms "
          f"for {st.tokens} steps ({st.decode_s / st.tokens * 1e3:.3f} ms/token{rows[0]}), "
          f"tokens of row 0 {out[0].tolist()}{rows[1]}; launches ssm_scan, flash_attention, "
          f"decode_attention {got} (expected {want})")
    if got != want:
        _fail(f"{label} launch counts {got} != {want}")
    if out.shape != (b, DECODE_STEPS) or not ((out >= 0) & (out < bundle.cfg.vocab_size)).all():
        _fail(f"{label} tokens out of range: {out}")
    return got, st


def check_logits(torch, bundle, model, prompt, label):
    """A prefill and one decode step on ``prompt``: (B, vocab) logits, finite
    (outside any counted run)."""
    with torch.inference_mode():
        tokens = torch.as_tensor(prompt, dtype=torch.int64, device=bundle.device)
        logits, caches, pos = bundle.prefill(model, {"tokens": tokens})
        steps = [logits]
        steps.append(bundle.decode_step(model, caches, logits.argmax(-1), pos)[0])
    for name, lg in zip(("prefill", "decode"), steps):
        if lg.shape != (prompt.shape[0], bundle.cfg.vocab_size) or not torch.isfinite(lg).all():
            _fail(f"{label} {name} logits: shape {tuple(lg.shape)} or not finite")
    print(f"{label}: prefill and decode logits {tuple(steps[0].shape)} finite")


def arch_serve_phase(torch, dev, cfg, label, *, wide=True):
    """``cfg`` in bf16 from seed-0 weights made on the card
    (registry.build + bundle.init), served by the engine's request loop
    (``engine.generate``): a warm-up (as the engine's code_init), then
    REQUESTS requests at B 1 and, with ``wide``, one at SERVE_B with exact
    launches (the main path) and finite logits; one traced request.  Returns
    the launches {B: (scan, flash, decode)} and the traced request's numbers."""
    import numpy as np
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.models import registry
    from repro_torch.serving.engine import generate

    n_attn = cfg.layer_pattern.count("A")
    want = (cfg.layer_pattern.count("M"), n_attn, n_attn * DECODE_STEPS)
    bundle = registry.build(cfg, max_seq=MAX_SEQ, device=dev)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    print(f"serve {label} bf16: weights {weights / 1e9:.3f} GB, init from seed 0 on the card "
          f"{time.perf_counter() - t0:.2f} s, its peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB (each leaf drawn in fp32, then cast)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, MAX_SEQ)) for _ in range(REQUESTS)]
    wides = [rng.integers(0, cfg.vocab_size, (SERVE_B, MAX_SEQ))] if wide else []
    for p in prompts[:1] + wides:                               # warm-up
        generate(bundle, model, p, decode_steps=1)
    ks.launches = kf.launches = kd.launches = 0                 # the main path starts here
    launches = {1: (0, 0, 0)}
    for i, p in enumerate(prompts):
        got, _ = serve_request(torch, bundle, model, p, f"serve {label} {i}", want)
        launches[1] = tuple(a + b for a, b in zip(launches[1], got))
    for p in wides:
        launches[SERVE_B], _ = serve_request(torch, bundle, model, p,
                                             f"serve {label} B {SERVE_B}", want)
    total = _counts()                                           # read just after the main path
    if min(n for n, w in zip(total, want) if w) == 0:
        _fail(f"a kernel of the {label} path was never launched: {total}")
    for p in wides:
        check_logits(torch, bundle, model, p, f"serve {label} B {SERVE_B}")
    profile = profile_serve(torch, lambda: _wall(generate(bundle, model, prompts[1],
                                                          decode_steps=DECODE_STEPS)[1]))
    print(f"serve {label}: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    del model
    _free(torch)
    return launches, profile


def arch_phase(torch, dev, arch, fp32_layers, bf16_layers):
    """One architecture of ARCHS: the fp32 check (kernel path against the
    plain path at B 1 and SERVE_B, the router gap met for an MoE), then the
    bf16 serve (through the InferenceEngine for ENGINE_ARCH).  Returns the
    serve's launches {B: (scan, flash, decode)} and its traced request."""
    from repro_torch.config import get_config

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=fp32_layers or full.num_layers,
                              dtype="float32", param_dtype="float32")
    label = f"{arch} x{cfg.num_layers} layers fp32"
    with router_gaps(torch, cfg, arch) if cfg.moe else contextlib.nullcontext():
        init = model_phase(torch, dev, cfg, label, batches=MODEL_BATCHES)
    over = init["peak"] / init["weights"] - 1
    print(f"model {label}: init peak {over:+.4f} of the weights' bytes (tol {INIT_TOL})")
    if over > INIT_TOL:
        _fail(f"{label}: init's peak {init['peak']} exceeds the weights' {init['weights']} bytes")
    torch.cuda.reset_peak_memory_stats()
    if arch == ENGINE_ARCH:
        print(f"serve {arch}: before the engine's snapshot, {_host_room()}")
        out = engine_phase(torch, arch, designs=False, batched=True, restore_gate=False)
        launches = {1: (0, out["flash_attention"], out["decode_attention"]),
                    SERVE_B: out["b8"][0]}
        profile = out["profile"]
    else:
        cfg = dataclasses.replace(full, num_layers=bf16_layers or full.num_layers)
        launches, profile = arch_serve_phase(torch, dev, cfg, f"{arch} x{cfg.num_layers}")
    peak = torch.cuda.max_memory_allocated()
    _free(torch)
    print(f"phase {arch}: {time.perf_counter() - t0:.1f} s; the bf16 serve's peak "
          f"{peak / 1e9:.2f} GB allocated")
    return launches, profile


def moe_card_vs_cpu(torch, dev, cfg, tokens: int, seed: int = 0):
    """One MoE layer of ``cfg`` (fp32, seed ``seed`` on ``dev``) on ``tokens``
    random tokens through ``moe._dispatch_group`` on the card and, with the
    same weights and tokens, on the CPU.  Returns the tokens whose top-k
    expert sets differ, with the gap between their k-th and (k+1)-th
    probability (the smaller of the two devices'), the smallest gap of any
    token, the largest output difference over the tokens whose sets agree
    relative to the largest output, and both aux losses."""
    from repro_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(seed)
    card = moe.MoE(cfg, device=dev, gen=gen)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=dev)
    host = moe.MoE(cfg, device="meta")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, assign=True)
    k = cfg.moe.top_k
    sets, gaps, outs = [], [], []
    with torch.inference_mode():
        for xx, p in ((x, card), (x.cpu(), host)):
            outs.append(moe._dispatch_group(xx, p, cfg))
            probs = torch.softmax(xx.float() @ p.router, dim=-1)
            w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
            sets.append(i[:, :k].sort(dim=-1).values.cpu())
            gaps.append((w[:, k - 1] - w[:, k]).cpu())
    gap = torch.minimum(*gaps)
    differ = (sets[0] != sets[1]).any(dim=-1)
    (y_card, aux_card), (y_cpu, aux_cpu) = outs
    agree = ~differ
    err = (y_card.cpu()[agree] - y_cpu[agree]).abs().max().item() if agree.any() else 0.0
    return dict(differ=differ.nonzero().flatten().tolist(), gaps=gap[differ].tolist(),
                min_gap=gap.min().item(), rel_err=err / y_cpu.abs().max().item(),
                aux=(aux_card.item(), aux_cpu.item()),
                params=sum(t.numel() for t in card.state_dict().values()))


def moe_layer_phase(torch, dev):
    """One full-width qwen3-moe MoE layer in fp32 on MOE_TOKENS tokens, card
    against CPU on the same weights: the sort, scatter, bmm and index_add_
    of ``_dispatch_group`` on each device."""
    from repro_torch.config import get_config

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32", param_dtype="float32")
    r = moe_card_vs_cpu(torch, dev, cfg, MOE_TOKENS)
    print(f"moe {MOE_ARCH} layer fp32 ({r['params'] / 1e6:.1f} M parameters, {MOE_TOKENS} "
          f"tokens, {cfg.moe.num_experts} experts top-{cfg.moe.top_k}) card vs CPU: "
          f"{len(r['differ'])} tokens route to other top-{cfg.moe.top_k} sets (gaps "
          f"{['%.3e' % g for g in r['gaps']]}; smallest gap of any token {r['min_gap']:.3e}); "
          f"outputs where the sets agree within {r['rel_err']:.3e} of the largest "
          f"(tol {MOE_TOL}); aux loss card {r['aux'][0]:.9f}, CPU {r['aux'][1]:.9f}; "
          f"{time.perf_counter() - t0:.1f} s")
    if any(g >= MOE_GAP for g in r["gaps"]):
        _fail(f"moe layer: a token routes apart on card and CPU at a gap >= {MOE_GAP}: {r}")
    if r["rel_err"] > MOE_TOL:
        _fail(f"moe layer: card and CPU outputs differ by {r['rel_err']:.3e} of the largest")
    _free(torch)


# --------------------------------------------------------------------------- #
# phases 37-41: the config's own long shapes (config.SHAPES) on one card
# --------------------------------------------------------------------------- #

RING_PROMPT = 8192            # long_500k's prompt cut to twice the 4096-slot ring
RING_ARCH = "h2o-danube-3-4b"
# the Jamba fp32 check's MoE capacity factor (1.25 in the config): 3x a
# group's mean load, so that no token drops (a dropped token couples a
# prefill's tokens, which a decode step never does); E / k (no drop by
# construction) would size the 8176-token group's experts at 7.5 GB each
RING_CHECK_CAPACITY = 3.0
# granite's fp32 self-consistency checks cut to 4 of 40 layers (the fp32
# flash kernel runs on the FMA units: ~2.9 s a B 8 layer at 32768), and
# decode_32k's B 8 check to 2 (its 4 took ~29 s of the script's time limit)
LONG_CHECK_LAYERS = 4
DECODE_32K_CHECK_LAYERS = 2
# (shape, name, B, Sq, Skv, window): the flash forward at the long paths'
# shapes; the ring's window over an 8192-token prompt, danube's D 120 and
# Jamba's D 128
LONG_FLASH_CASES = [
    ("granite", "prefill_32k", 1, 32768, 32768, None),
    ("granite", "decode_32k_prefill", DECODE_32K_B, 32768 - DECODE_STEPS, 32768 - DECODE_STEPS, None),
    ("danube", "ring_prefill", 1, RING_PROMPT, RING_PROMPT, 4096),
    ("jamba", "ring_prefill", 1, RING_PROMPT, RING_PROMPT, 4096)]
# (shape, name, B, S, last valid row): the decode kernel on a 32768-row cache
# (decode_32k's first step at B 8; the last row at B 1) and on the wrapped
# 4096-slot ring (every row valid)
LONG_DECODE_CASES = [
    ("granite", "decode_32k", DECODE_32K_B, 32768, 32768 - DECODE_STEPS),
    ("granite", "cache_32k_b1", 1, 32768, 32767),
    ("danube", "ring", 1, 4096, 4095),
    ("jamba", "ring", 1, 4096, 4095)]
LONG_SCAN = (1, RING_PROMPT, 8192, 16)   # the Jamba prefill's scan at the ring's prompt
LONG_REPS = dict(reps=2, iters=3)        # graphs of calls of milliseconds


def long_kernel_phase(torch, dev):
    """Phase 37: each hand kernel against its plain version at the long paths'
    shapes, fp32 (TF32 off) and bf16 (KERNEL_TOL, SSM_TOL; the attention
    kernels in bf16 also ROW_TOL, which must refuse the kernel with its last
    key tile dropped): the flash forward
    at Skv 32768 (B 1) and 32752 (B 8, bf16: the path's dtype; the fp32
    kernel takes ~2.9 s a call there), and with the 4096 window over 8192
    (danube, Jamba), its plain version over slices of q rows; the decode
    kernel at 32768 rows (B 8, B 1) and on the wrapped 4096-slot ring; the
    scan at T 8192.  The bf16 calls timed (device ms by graph replay, launch
    by launch; the plain version once; SDPA beside attention) with their
    bounds; the flash forward's prologue (every block reads every key
    position before its loop) measured by the same calls with window 1."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.kernels.ref import attention_mask
    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(37)
    timed = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for shape, name, b, sq, skv, window in LONG_FLASH_CASES:
            if b > 1 and dtype == "float32":
                continue      # fp32 at Skv 32768 is held at B 1; the B 8 path runs bf16
            hq, hkv, d = ATTN_SHAPES[shape]
            q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(tdt)
            k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(tdt)
                    for _ in range(2))
            q_pos = torch.arange(sq, device=dev, dtype=torch.int32) + (skv - sq)
            kv_pos = torch.arange(skv, device=dev, dtype=torch.int32)
            args = dict(causal=True, window=window, q_pos=q_pos, kv_pos=kv_pos)
            t1 = time.perf_counter()
            got = kf.flash_attention_hopper(q, k, v, **args)
            torch.cuda.synchronize()
            t_kernel = time.perf_counter() - t1
            want = []
            plain_ms = _event_ms(torch, lambda: want.append(kf.flash_attention_plain_rows(
                q, k, v, **args)))
            err, row, ok = _long_close(got, want[0], dtype)
            print(f"kernel flash_attention {dtype} {shape} {hq}/{hkv} D={d} {name} B={b} Sq={sq} "
                  f"Skv={skv} window={window} causal=True: max_abs_err={err:.3e} "
                  f"tol={KERNEL_TOL[dtype]}{_rows(row)} (plain over q-row slices) "
                  f"{'ok' if ok else 'FAIL'}; first call "
                  f"{t_kernel:.3f} s")
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"flash_attention {dtype} {shape} {name} disagrees with its plain version")
            del got
            if dtype != "bfloat16":
                del want
                continue
            # the kernel over every key but the last tile's 64 (the last q
            # tile's rows lose their nearest keys)
            bad = kf.flash_attention_hopper(q, k[:, :-64].contiguous(), v[:, :-64].contiguous(),
                                            **dict(args, kv_pos=kv_pos[:-64]))
            _gate_rejects(f"flash_attention {shape} {name}", dtype, bad, want[0])
            del want, bad
            pairs = roofline.attention_pairs(sq, skv, causal=True, window=window)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            amask = None if window is None else attention_mask(q_pos, kv_pos, causal=True,
                                                               window=window)
            t = dict(max_abs_err=err, label=f"B {b}, Sq {sq}, Skv {skv}, window {window}",
                     bound=_bound(roofline.flash_work(b, sq, skv, hq, hkv, d, q.element_size(),
                                                      pairs)),
                     **_attn_times(torch, lambda: kf.flash_attention_hopper(q, k, v, **args),
                                   None, lambda: F.scaled_dot_product_attention(
                                       qt, kt, vt, attn_mask=amask, is_causal=amask is None,
                                       enable_gqa=True), plain_ms=plain_ms, **LONG_REPS))
            timed[("flash_attention", shape, name)] = t
            _print_time("flash_attention", dtype, shape, name, t)
            if b == 1:
                # window 1: every block's loop runs one or two key tiles, so
                # the call is the launch and the prologue's scan of Skv keys
                few = _graph_ms(torch, lambda: kf.flash_attention_hopper(
                    q, k, v, causal=True, window=1, q_pos=q_pos, kv_pos=kv_pos), **LONG_REPS)
                print(f"time flash_attention prologue bf16 ({shape} {name}): the same call with "
                      f"window 1 (one or two key tiles a block) {few:.4f} ms against "
                      f"{t['ms']:.4f} ms: the prologue and launch at most "
                      f"{few / t['ms']:.3f} of the call")
            del q, k, v, qt, kt, vt
            _free(torch)
        for shape, name, b, s, last in LONG_DECODE_CASES:
            hq, hkv, d = ATTN_SHAPES[shape]
            q = torch.randn((b, hq, d), generator=gen, device=dev).to(tdt)
            k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(tdt)
                    for _ in range(2))
            mask = (torch.arange(s, device=dev) <= last)[None].expand(b, s).contiguous()
            got = kd.decode_attention_hopper(q, k, v, mask)
            want = kd.decode_attention_plain(q, k, v, mask)
            err, row, ok = _long_close(got, want, dtype)
            splits = kd.decode_splits(b, s, hkv, kd._sms(0))
            print(f"kernel decode_attention {dtype} {shape} {hq}/{hkv} D={d} {name} B={b} S={s} "
                  f"rows 0-{last} valid, splits={splits} ({-(-s // splits)} rows a split, "
                  f"{splits * b * hkv} blocks, {kd.split_smem_bytes(hq // hkv, d)} B shared a "
                  f"block): max_abs_err={err:.3e} tol={KERNEL_TOL[dtype]}{_rows(row)} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"decode_attention {dtype} {shape} {name} disagrees with its plain version")
            if dtype != "bfloat16":
                continue
            # the kernel with the last valid 32-row tile's rows masked out
            short = mask.clone()
            short[:, last - 31:last + 1] = False
            _gate_rejects(f"decode_attention {shape} {name}", dtype,
                          kd.decode_attention_hopper(q, k, v, short), want)
            del short
            n_valid = mask.sum().item()
            qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
            amask = mask[:, None, None, :]
            t = dict(max_abs_err=err, label=f"B {b}, S {s}, {n_valid} valid, {splits} splits",
                     bound=_bound(roofline.decode_work(b, s, hq, hkv, d, k.element_size(),
                                                       n_valid)),
                     **_attn_times(torch, lambda: kd.decode_attention_hopper(q, k, v, mask),
                                   lambda: kd.decode_attention_plain(q, k, v, mask),
                                   lambda: F.scaled_dot_product_attention(
                                       qt, kt, vt, attn_mask=amask, enable_gqa=True)))
            timed[("decode_attention", shape, name)] = t
            _print_time("decode_attention", dtype, shape, name, t)
        args = _ssm_inputs(torch, gen, *LONG_SCAN, dtype)
        got = ks.ssm_scan_hopper(*args)
        want = ks.ssm_scan_plain(*args)
        errs = [_close(g, w, SSM_TOL[dtype]) for g, w in zip(got, want)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        print(f"kernel ssm_scan {dtype} jamba ring prefill Bt,T,Din,N={LONG_SCAN}: y, hT "
              f"max_abs_err={err:.3e} tol={SSM_TOL[dtype]} {'ok' if ok else 'FAIL'}")
        if not ok or not all(torch.isfinite(g.float()).all() for g in got):
            _fail(f"ssm_scan {dtype} at T {LONG_SCAN[1]} disagrees with its plain version")
        if dtype == "bfloat16":
            t = dict(max_abs_err=err, label="Bt {}, T {}, Din {}, N {}".format(*LONG_SCAN),
                     ms=_graph_ms(torch, lambda: ks.ssm_scan_hopper(*args), reps=4, iters=5),
                     launch_ms=_time_ms(torch, lambda: ks.ssm_scan_hopper(*args), iters=10),
                     plain_ms=_event_ms(torch, lambda: ks.ssm_scan_plain(*args)),
                     library_ms=None,
                     bound=_bound(roofline.ssm_scan_work(*LONG_SCAN, args[0].element_size())))
            timed[("ssm_scan", "jamba", "ring_prefill")] = t
            _print_time("ssm_scan", dtype, "scan", "jamba ring_prefill", t)
        del args, got, want
        _free(torch)
    print(f"phase long-kernels: {time.perf_counter() - t0:.1f} s")
    return timed


def _layer_counts(cfg):
    """``cfg``'s Mamba and attention layers: the scan's and flash's launches
    a prefill, and (attention) decode's a step."""
    return cfg.layer_pattern.count("M"), cfg.layer_pattern.count("A")


def self_consistency(torch, dev, cfg, shape, label, *, b, s):
    """``cfg`` in fp32 from seed-0 weights: the last position's logits of a
    prefill of ``s`` tokens against those of a prefill of ``s`` - DECODE_STEPS
    tokens followed by DECODE_STEPS decode steps fed the same tokens.  One
    function by two routes (the flash forward over the whole prompt; the
    decode kernel over the cache or the wrapped ring and the scan's state
    handed to the decode steps), held within MODEL_TOL, with exact launches."""
    from repro_torch.models import registry

    t0 = time.perf_counter()
    bundle = registry.build(cfg, shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    n_m, n_a = _layer_counts(cfg)
    before = _counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        whole, caches, _ = bundle.prefill(model, {"tokens": tokens})
        del caches
        logits, caches, pos = bundle.prefill(model, {"tokens": tokens[:, :s - DECODE_STEPS]})
        for i in range(DECODE_STEPS):
            logits, caches = bundle.decode_step(model, caches, tokens[:, s - DECODE_STEPS + i],
                                                pos + i)
        rows = caches[cfg.layer_pattern.index("A")]["k"].shape[1]
        del caches
    got = tuple(a - c for a, c in zip(_counts(), before))
    want = (2 * n_m, 2 * n_a, n_a * DECODE_STEPS)
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(whole).all())
    err, ok = _close(logits, whole, MODEL_TOL)
    print(f"self-consistency {label} fp32 B {b}: prefill of {s} tokens against a prefill of "
          f"{s - DECODE_STEPS} and {DECODE_STEPS} decode steps ({rows}-row attention cache, window "
          f"{bundle.window}): last logits max |diff| {err:.3e} (logit scale "
          f"{whole.abs().max().item():.3f}) tol={MODEL_TOL} {'ok' if ok and finite else 'FAIL'}; "
          f"launches ssm_scan, flash_attention, decode_attention {got} (expected {want}); "
          f"{time.perf_counter() - t0:.1f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if whole.shape != (b, cfg.vocab_size) or not finite or not ok:
        _fail(f"self-consistency {label}: prefill and prefill + decode disagree")
    if got != want:
        _fail(f"self-consistency {label}: launches {got} != {want}")
    del model
    _free(torch)


def _fp32(cfg, **changes):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32", **changes)


def long_serve(torch, dev, cfg, shape, label, prompt):
    """``cfg`` in bf16 from seed-0 weights made on the card, one request of
    ``prompt`` (B rows) through the engine's request loop (``serve_request``:
    exact launches, tokens in range); then a second prefill, timed (the
    request's is the first at its shape in the process), and its
    DECODE_STEPS greedy decode steps traced, for the decode steps' device
    busy share against the request's unprofiled decode wall.  Returns the
    launches (scan, flash, decode) and the numbers."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.models import registry

    t0 = time.perf_counter()
    bundle = registry.build(cfg, shape, device=dev)
    torch.cuda.reset_peak_memory_stats()
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    n_m, n_a = _layer_counts(cfg)
    ks.launches = kf.launches = kd.launches = 0                 # the main path starts here
    got, st = serve_request(torch, bundle, model, prompt, f"long {label}",
                            (n_m, n_a, n_a * DECODE_STEPS))
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        tokens = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, caches, pos = bundle.prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t1) * 1e3
        if logits.shape != (prompt.shape[0], cfg.vocab_size) or not torch.isfinite(logits).all():
            _fail(f"long {label}: prefill logits {tuple(logits.shape)} or not finite")
        attn = caches[cfg.layer_pattern.index("A")]["k"].shape
        state = {"caches": caches, "logits": logits}
        del caches, logits

        def steps():
            c, lg = state.pop("caches"), state.pop("logits")
            for i in range(DECODE_STEPS):
                tok = lg.argmax(-1)
                tok.cpu()                                       # as generate's loop does
                lg, c = bundle.decode_step(model, c, tok, pos + i)
            if not torch.isfinite(lg).all():
                _fail(f"long {label}: decode logits not finite")

        busy = _profile_call(torch, st.decode_s, steps,
                             f"long {label} {DECODE_STEPS} decode steps", top=8,
                             also=("decode_attn",))
    idle = "not measured" if busy is None else f"{1 - busy:.3f}"
    print(f"long {label} bf16: {weights / 1e9:.3f} GB of weights, max_seq {bundle.max_seq}, "
          f"window {bundle.window}, attention cache {tuple(attn)}; the request's peak "
          f"{peak / 1e9:.2f} GB allocated; a second prefill {again_ms:.2f} ms; decode idle "
          f"share {idle}; {time.perf_counter() - t0:.1f} s")
    del model, state
    _free(torch)
    return got, dict(prefill_ms=(st.prefill_s * 1e3, again_ms),
                     ms_token=st.decode_s / DECODE_STEPS * 1e3, peak=peak, busy=busy)


def prefill_32k_phase(torch, dev, timed):
    """Phase 38 (P1): ``prefill_32k`` on full-width granite-3-2b in bf16 at
    B 1 (the shape's batch of 32 cut: its 85.9 GB of KV cache), two prefills
    of 32768 tokens through ``registry.build(cfg, SHAPES["prefill_32k"])``'s
    bundle, exact launches (one flash a layer a prefill), finite (1, vocab)
    logits; the roofline's bound for the same work beside the measured time;
    then the fp32 self-consistency at 4 layers."""
    from repro_torch.config import SHAPES, InputShape, get_config
    from repro_torch.launch import roofline
    from repro_torch.models import registry

    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    shape = SHAPES["prefill_32k"]
    s = shape.seq_len
    bundle = registry.build(cfg, shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=dev)
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssm_scan as ks

    times = []
    with torch.inference_mode():
        ks.launches = kf.launches = kd.launches = 0             # the main path starts here
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, caches, pos = bundle.prefill(model, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            rows = caches[0]["k"].shape
            del caches
        got = _counts()                                         # read just after it
    peak = torch.cuda.max_memory_allocated()
    want = (0, 2 * cfg.num_layers, 0)
    print(f"prefill_32k {ARCH} bf16 B 1 x {s}: prefill ms {[round(x * 1e3, 2) for x in times]}, "
          f"caches {tuple(rows)} a layer, next position {pos}, peak {peak / 1e9:.2f} GB "
          f"allocated; launches ssm_scan, flash_attention, decode_attention {got} "
          f"(expected {want})")
    if got != want:
        _fail(f"prefill_32k: launch counts {got} != {want}")
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all() or pos != s:
        _fail(f"prefill_32k: logits {tuple(logits.shape)} not finite, or position {pos} != {s}")
    del model, logits
    _free(torch)
    rec = roofline.analyze(cfg, InputShape("prefill_32k", s, 1, "prefill"))
    best = min(times)
    flash = timed[("flash_attention", "granite", "prefill_32k")]
    print(f"roofline {ARCH} prefill_32k (B 1 x S {s}) on one H100: bound "
          f"{rec['bound_s'] * 1e3:.3f} ms ({rec['dominant']}: compute "
          f"{rec['compute_s'] * 1e3:.3f} ms, memory {rec['memory_s'] * 1e3:.3f} ms), FLOPs "
          f"{rec['flops_per_device']:.4e} (flash's {rec['kernel_work']['flash_attention']['flops']:.4e}); "
          f"measured {best * 1e3:.3f} ms; bound / measured {rec['bound_s'] / best:.3f}; the flash "
          f"forward a call {flash['ms']:.4f} ms (x{cfg.num_layers} = "
          f"{flash['ms'] * cfg.num_layers:.2f} ms), sdpa {flash['library_ms']:.4f} ms, bound "
          f"{flash['bound'][0]:.4f} ms")
    if not rec["bound_s"] <= best:
        _fail(f"roofline prefill_32k: bound {rec['bound_s']} s above the measured {best} s")
    self_consistency(torch, dev, _fp32(cfg, num_layers=LONG_CHECK_LAYERS), shape,
                     f"{ARCH} x{LONG_CHECK_LAYERS} layers prefill_32k", b=1, s=s)
    print(f"phase prefill_32k: {time.perf_counter() - t0:.1f} s")
    return got[1], dict(prefill_ms=best * 1e3, peak=peak, bound_ms=rec["bound_s"] * 1e3)


def decode_32k_phase(torch, dev):
    """Phase 39 (P2): ``decode_32k`` on full-width granite-3-2b in bf16 at
    B DECODE_32K_B (the shape's 128 cut: 343.6 GB of KV cache): 8 prompts of
    32752 tokens in one prefill at max_seq 32768, then DECODE_STEPS decode
    steps, the last at position 32767 (``long_serve``); then the fp32
    self-consistency at DECODE_32K_CHECK_LAYERS layers, B 8."""
    import numpy as np
    from repro_torch.config import SHAPES, get_config

    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    shape = SHAPES["decode_32k"]
    s = shape.seq_len
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (DECODE_32K_B, s - DECODE_STEPS))
    launches, r = long_serve(torch, dev, cfg, shape, f"{ARCH} decode_32k", prompt)
    self_consistency(torch, dev, _fp32(cfg, num_layers=DECODE_32K_CHECK_LAYERS), shape,
                     f"{ARCH} x{DECODE_32K_CHECK_LAYERS} layers decode_32k", b=DECODE_32K_B, s=s)
    print(f"phase decode_32k: {time.perf_counter() - t0:.1f} s")
    return launches, r


def train_4k_phase(torch, dev):
    """Phase 40 (P3): ``train_4k`` on full-width granite-3-2b, bf16 weights,
    fp32 AdamW in place, remat, S 4096 at the largest batch of
    TRAIN_4K_BATCHES that fits (each that does not printed), TRAIN_4K_STEPS
    steps at lr 3e-3 through ``launch/train.py``'s main (``train_phase``:
    exact launches, finite falling losses, one traced step).  The flash
    forward and backward at (8, 4096) are held and timed with the other
    training shapes (``flash_bwd_phase``)."""
    from repro_torch.config import get_config
    from repro_torch.launch import train as launcher

    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    s = TRAIN_4K_SEQ
    b, (launches, res) = _fit_batch(torch, f"train_4k {ARCH}", TRAIN_4K_BATCHES, s, lambda b: (
        train_phase(torch, dev, cfg, f"{ARCH} train_4k", lambda: launcher.main(
            ["--arch", ARCH, "--steps", str(TRAIN_4K_STEPS), "--batch", str(b),
             "--seq", str(s), "--device", dev.type]), steps=TRAIN_4K_STEPS, shape=(b, s))))
    _train_bound(cfg, f"train_4k {ARCH}", (b, s), res)
    print(f"phase train_4k: {time.perf_counter() - t0:.1f} s")
    return launches, res


def _fit_batch(torch, label, batches, s, attempt):
    """The first batch of ``batches`` for which ``attempt(b)`` runs without
    running out of device memory (each that does not printed): (b, its
    result)."""
    for b in batches:
        try:
            return b, attempt(b)
        except torch.OutOfMemoryError as e:
            failure = str(e).splitlines()[0]
        print(f"{label} B {b} x S {s}: does not fit one card ({failure})")
        _free(torch)
    _fail(f"{label}: no batch of {batches} fits")


def _train_bound(cfg, label, shape, res):
    """One train step of ``cfg`` at B x S ``shape`` as ``train_phase`` measured
    it (``res``), beside launch/roofline.py's bound on one H100; the bound
    must not exceed the measured step."""
    from repro_torch.config import InputShape
    from repro_torch.launch import roofline

    b, s = shape
    busy = "not measured" if res["busy"] is None else f"{res['busy']:.3f}"
    rec = roofline.analyze(cfg, InputShape("train", s, b, "train"))
    print(f"{label}: chosen B {b} x S {s}; {res['step_s'] * 1e3:.1f} ms a step after "
          f"step 1, {b * s / res['step_s']:.0f} tokens/s, peak {res['peak'] / 1e9:.2f} GB, busy "
          f"share {busy}; roofline bound {rec['bound_s'] * 1e3:.3f} ms ({rec['dominant']}: "
          f"compute {rec['compute_s'] * 1e3:.3f} ms, memory {rec['memory_s'] * 1e3:.3f} ms), "
          f"bound / measured {rec['bound_s'] / res['step_s']:.3f}")
    if not rec["bound_s"] <= res["step_s"]:
        _fail(f"roofline {label}: bound {rec['bound_s']} s above the measured {res['step_s']} s")


def ring_cfgs():
    """long_500k's ring models: full-width h2o-danube-3-4b and one full-width
    Jamba period (depth 32 -> 8, as the hybrid phases)."""
    from repro_torch.config import get_config

    return [(RING_ARCH, get_config(RING_ARCH)),
            (f"{HYBRID} x{HYBRID_LAYERS}",
             dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_LAYERS))]


def long_ring_phase(torch, dev, label, cfg):
    """Phase 41 (P4): ``long_500k`` on ``cfg``, B 1, built with
    ``SHAPES["long_500k"]`` (max_seq 524288), so that each attention layer's
    cache is a ring of min(window, max_seq) = 4096 slots: an 8192-token
    prompt (the ring rolled in prefill), DECODE_STEPS decode steps each
    overwriting the oldest slot (``long_serve``); then the fp32
    self-consistency at full depth (an MoE's capacity raised so that no
    token drops: dropping couples a prefill's tokens, which a decode step
    never does; the smallest router gap and the largest expert load met
    printed, a load past its capacity fatal)."""
    import numpy as np
    from repro_torch.config import SHAPES

    t0 = time.perf_counter()
    shape = SHAPES["long_500k"]
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, RING_PROMPT))
    launches, r = long_serve(torch, dev, cfg, shape, f"{label} long_500k", prompt)
    moe = {}
    if cfg.moe is not None:
        moe = {"moe": dataclasses.replace(cfg.moe, capacity_factor=RING_CHECK_CAPACITY)}
    check = _fp32(cfg, **moe)
    with router_gaps(torch, check, label) if cfg.moe else contextlib.nullcontext() as seen:
        self_consistency(torch, dev, check, shape, f"{label} long_500k", b=1, s=RING_PROMPT)
    if seen is not None and seen["load"] > seen["cap"]:
        _fail(f"self-consistency {label}: an expert's load {seen['load']} passed its capacity "
              f"{seen['cap']}, so tokens dropped and the two routes differ by design")
    print(f"phase long_500k {label}: {time.perf_counter() - t0:.1f} s")
    return launches, r



# --------------------------------------------------------------------------- #
# phases 42-47: full-width training of whisper-large-v3, internvl2-1b and
# xlstm-125m through launch/train.py, and the InferenceEngine at SERVE_B
# --------------------------------------------------------------------------- #

FULL_TRAIN_STEPS = 5
# an xlstm-125m step walks 256 time steps of 12 recurrent layers in eager ops
# (~4.6e5 device activities, host-bound: 15.4 s a step on an H100 80GB HBM3
# at 700 W): 2 steps, the second the steady one
XLSTM_TRAIN_STEPS = 2
XLSTM_TRAIN_BATCHES = (8, 4, 2, 1)   # the largest that fits (the mLSTM saves its states)
# xlstm has no hand kernel: its fp32 gradients are held card against CPU, at
# full width cut to one mLSTM + sLSTM pair over 64 steps (the CPU's seconds)
XLSTM_GRAD_LAYERS, XLSTM_GRAD_SHAPE = 2, (1, 64)
# the sLSTM's h = o * c / n is unchanged by a constant added to every input
# gate pre-activation (c and n both scale by its exp), so the gradient of the
# input gate's bias (gi.b) is exactly 0: ~6e-11 of rounding on the CPU, where
# the next smallest leaf's is ~1e-4 and the largest ~0.39.  Such a leaf has
# no scale of its own; a leaf below XLSTM_ZERO of the largest on both sides
# is held to that floor instead of to 1e-3 of its own largest
XLSTM_ZERO = 1e-6
# the B 8 engines (arch, max_seq, flash a prefill, decode a step)
ENGINES_B8 = [(ARCH, MAX_SEQ), (ENCDEC, ENCDEC_SEQ), (VISION, MAX_SEQ)]
# the fp32 row check: each engine's model cut to ROW_LAYERS layers (whisper
# ROW_LAYERS + ROW_LAYERS), its SERVE_B rows in one call against each row
# alone, last logits after the prefill and each decode step
ROW_LAYERS = 4
BATCH_ROW_TOL = 1e-3


def _train_seq(arch):
    return VISION_TRAIN_SEQ if arch == VISION else TRAIN_SHAPE[1]


def full_train_phase(torch, dev, arch, ckdir):
    """Phases 42-43: full-width ``arch`` (whisper-large-v3, internvl2-1b):
    the fp32 gradients at B 1 through the hand kernels against the plain
    path (GRAD_TOL), then FULL_TRAIN_STEPS bf16 steps through
    ``launch/train.py``'s main at B 8 (``train_phase``'s gates) writing
    ``--checkpoint``, and the roofline's bound beside the step.  Returns the
    launches, ``train_phase``'s numbers and the checkpoint's path."""
    from repro_torch.config import get_config
    from repro_torch.launch import train as launcher

    t0 = time.perf_counter()
    cfg = get_config(arch)
    b, s = TRAIN_SHAPE[0], _train_seq(arch)
    print(f"train {arch}: {cfg.param_count() / 1e9:.3f} B parameters, {_flash_calls(cfg)} "
          f"flash calls a forward pass")
    train_grad_phase(torch, dev, cfg, arch, (1, s))
    path = str(Path(ckdir) / f"{arch}.npz")
    launches, res = train_phase(torch, dev, cfg, arch, lambda: launcher.main(
        ["--arch", arch, "--steps", str(FULL_TRAIN_STEPS), "--batch", str(b), "--seq", str(s),
         "--device", dev.type, "--checkpoint", path]), steps=FULL_TRAIN_STEPS, shape=(b, s))
    _train_bound(cfg, f"train {arch}", (b, s), res)
    print(f"phase train {arch}: {time.perf_counter() - t0:.1f} s; checkpoint "
          f"{Path(path).stat().st_size / 1e9:.3f} GB")
    return launches, res, path


def xlstm_grad_phase(torch, dev):
    """xlstm-125m in fp32 cut to XLSTM_GRAD_LAYERS layers: the loss and every
    leaf's gradient on the card against the CPU from one set of weights
    (GRAD_TOL); no hand kernel is on its path."""
    from repro_torch.config import InputShape, get_config
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.training.train_loop import to_device, value_and_grad

    cfg = dataclasses.replace(get_config(XLSTM), num_layers=XLSTM_GRAD_LAYERS,
                              dtype="float32", param_dtype="float32")
    b, s = XLSTM_GRAD_SHAPE
    card = registry.build(cfg, max_seq=s, device=dev)
    host = registry.build(cfg, max_seq=s, device="cpu")
    model = card.init(torch.Generator(device=dev).manual_seed(0))
    ref = host.empty()
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    batch = next(pipeline.batches(cfg, InputShape("train", s, b, "train")))
    t0 = time.perf_counter()
    lc, _, gc = value_and_grad(card, model, to_device(batch, dev))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    lh, _, gh = value_and_grad(host, ref, to_device(batch, torch.device("cpu")))
    t_host = time.perf_counter() - t0
    _gate_grads(torch, f"train-grad {XLSTM} x{cfg.num_layers} ({cfg.layer_pattern}) fp32 B {b} "
                f"x S {s}", (lc.cpu(), gc), (lh, gh), names=("card", "CPU"), zero=XLSTM_ZERO)
    print(f"train-grad {XLSTM} fp32: loss + grads {t_card:.2f} s on the card, {t_host:.2f} s "
          f"on the CPU")
    del model, ref, gc, gh
    _free(torch)


def xlstm_train_phase(torch, dev):
    """Phase 44: xlstm-125m at full width, the card's fp32 gradients against
    the CPU's, then XLSTM_TRAIN_STEPS bf16 steps through ``launch/train.py``'s
    main at the largest batch of XLSTM_TRAIN_BATCHES that fits (each that
    does not printed), no hand-kernel launch; the roofline's bound beside."""
    from repro_torch.config import get_config
    from repro_torch.launch import train as launcher

    t0 = time.perf_counter()
    cfg = get_config(XLSTM)
    xlstm_grad_phase(torch, dev)
    s = TRAIN_SHAPE[1]
    b, (_, res) = _fit_batch(torch, f"train {XLSTM}", XLSTM_TRAIN_BATCHES, s, lambda b: (
        train_phase(torch, dev, cfg, XLSTM, lambda: launcher.main(
            ["--arch", XLSTM, "--steps", str(XLSTM_TRAIN_STEPS), "--batch", str(b),
             "--seq", str(s), "--device", dev.type]), steps=XLSTM_TRAIN_STEPS, shape=(b, s))))
    _train_bound(cfg, f"train {XLSTM}", (b, s), res)
    print(f"phase train {XLSTM}: {time.perf_counter() - t0:.1f} s")
    return res


def engine_b8_phase(torch, arch, max_seq):
    """Phase 45: the bf16 full-width InferenceEngine built for SERVE_B rows
    (``engine_phase``): cold start with its warm-up at the B 8 spec,
    REQUESTS requests of 8 different prompts (and extras), the served tokens
    against engine.generate's, rows not all equal, restore and the first
    request again, exact launches (a B 8 request launches what a B 1 request
    does), one traced request; restore against cold start printed."""
    from repro_torch.config import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    extras = None if cfg.encoder is None and cfg.vision is None else \
        _extras(torch, cfg, SERVE_B)[1]
    out = engine_phase(torch, arch, max_seq=max_seq, launches=_serve_calls(cfg), extras=extras,
                       zero_tail=cfg.encoder is not None, designs=False, restore_gate=False,
                       batch=SERVE_B)
    _free(torch)
    print(f"phase engine {arch} B {SERVE_B}: {time.perf_counter() - t0:.1f} s")
    return out


def _row_cfg(arch):
    """``arch`` in fp32 cut to ROW_LAYERS layers (an encoder too)."""
    from repro_torch.config import get_config

    cfg = get_config(arch)
    cut = dict(num_layers=ROW_LAYERS, dtype="float32", param_dtype="float32")
    if cfg.encoder is not None:
        cut["encoder"] = dataclasses.replace(cfg.encoder, num_layers=ROW_LAYERS)
    return dataclasses.replace(cfg, **cut)


def batch_rows_phase(torch, dev, arch, max_seq):
    """Phase 46: row independence at SERVE_B.  ``arch`` in fp32 cut to
    ROW_LAYERS layers: SERVE_B different prompts of max_seq - DECODE_STEPS
    tokens (and extras) in one prefill and DECODE_STEPS greedy decode steps,
    against each row's prompt alone (B 1) fed the same tokens; the last
    logits after the prefill and after each step within BATCH_ROW_TOL.  The
    gate must refuse the B 8 logits with rows 0 and 1 swapped."""
    from repro_torch.models import registry

    cfg = _row_cfg(arch)
    bundle = registry.build(cfg, max_seq=max_seq, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = bundle.init(gen)
    prompt = max_seq - DECODE_STEPS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_B, prompt), generator=gen,
                                     device=dev)}
    if cfg.encoder is not None or cfg.vision is not None:
        batch.update(_extras(torch, cfg, SERVE_B)[0](gen))

    def run(inputs, fed=None):
        """(B, 1 + DECODE_STEPS, vocab) last logits and the tokens fed."""
        logits, caches, pos = bundle.prefill(model, inputs)
        out, toks = [logits], []
        for i in range(DECODE_STEPS):
            tok = logits.argmax(-1) if fed is None else fed[:, i]
            toks.append(tok)
            logits, caches = bundle.decode_step(model, caches, tok, pos + i)
            out.append(logits)
        return torch.stack(out, dim=1), torch.stack(toks, dim=1)

    with torch.inference_mode():
        wide, fed = run(batch)
        narrow = torch.cat([run({k: v[r:r + 1] for k, v in batch.items()}, fed[r:r + 1])[0]
                            for r in range(SERVE_B)])
    if not torch.isfinite(wide).all():
        _fail(f"rows {arch}: B {SERVE_B} logits are not finite")
    err, ok = _close(wide, narrow, BATCH_ROW_TOL)
    per_row = [(wide[r] - narrow[r]).abs().max().item() for r in range(SERVE_B)]
    swapped = wide[[1, 0, *range(2, SERVE_B)]]
    bad_err, bad_ok = _close(swapped, narrow, BATCH_ROW_TOL)
    print(f"rows {arch} x{cfg.num_layers} fp32, B {SERVE_B} x {prompt}-token prompts + "
          f"{DECODE_STEPS} decode steps against each row alone: max |logit err| {err:.3e} "
          f"(per row {', '.join(f'{e:.1e}' for e in per_row)}; logit scale "
          f"{narrow.abs().max().item():.3f}) tol={BATCH_ROW_TOL} {'ok' if ok else 'FAIL'}; "
          f"{len(set(map(tuple, fed.tolist())))} distinct rows of tokens")
    print(f"gate rows {arch}, the B {SERVE_B} logits with rows 0 and 1 swapped: max |logit err| "
          f"{bad_err:.3e} (refused {not bad_ok})")
    if not ok:
        _fail(f"rows {arch}: a row at B {SERVE_B} disagrees with the same prompt alone")
    if bad_ok:
        _fail(f"rows {arch}: the row gate passes the B {SERVE_B} logits with two rows swapped")
    del model, wide, narrow
    _free(torch)


def trained_serve_phase(torch, arch, path):
    """Phase 47: the checkpoint ``launch/train.py`` wrote for full-width
    ``arch`` loaded into a SnapshotStore under the key of an engine built for
    SERVE_B rows at the trained sequence length (whisper's learned position
    table has that many rows), the engine cold-started from it and serving
    SERVE_B prompts: its weights are the checkpoint's, its prefill logits
    finite, not equal in every row and within MODEL_TOL of a prefill on the
    checkpoint's weights loaded straight from the file, and its tokens those
    of ``engine.generate`` on those weights, with exact launches.  whisper's
    prompt fills its table, so its decode steps read past it (NaN, token 0)
    and the tokens check the prefill's token alone; 5 steps at lr 3e-3 may
    also give every row one argmax, so the rows are held apart by their
    logits, not their tokens."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models import registry
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore, generate
    from repro_torch.training import checkpoint

    t0 = time.perf_counter()
    cfg = get_config(arch)
    seq = _train_seq(arch)
    trained, extra = checkpoint.restore(path)
    state = {k: v if torch.is_tensor(v) else torch.from_numpy(v) for k, v in trained.items()}
    size = sum(_nbytes(v) for v in state.values())
    print(f"serve-trained {arch}: checkpoint {extra} read, {size / 1e9:.3f} GB; before the "
          f"store pins it, {_host_room()}")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (SERVE_B, seq)).astype(np.int32)
    extras = _extras(torch, cfg, SERVE_B)[1](rng)
    per_prefill, per_step = _serve_calls(cfg)
    want_launches = (per_prefill, per_step * DECODE_STEPS)
    with tempfile.TemporaryDirectory() as snapdir:
        store = SnapshotStore(snapdir)
        eng = InferenceEngine(arch, smoke=False, max_seq=seq, batch=SERVE_B, store=store,
                              device="cuda")
        dev = eng.device
        store.save_params(eng.key, state)
        bd = eng.cold_start(from_snapshot=True)
        same = all(torch.equal(p.cpu(), state[k]) for k, p in eng.params.state_dict().items())
        c = (kf.launches, kd.launches)
        out, st = eng.serve(tokens, decode_steps=DECODE_STEPS, extras=extras)
        got = (kf.launches - c[0], kd.launches - c[1])
        served = _prefill_logits(torch, eng.bundle, eng.params, tokens, extras,
                                 f"serve-trained {arch} engine")
        eng.shutdown()
    bundle = registry.build_arch(arch, smoke=False, max_seq=seq, device=dev)
    model = bundle.empty()
    model.load_state_dict({k: v.to(dev) for k, v in state.items()}, assign=True)
    want, _ = generate(bundle, model, tokens, decode_steps=DECODE_STEPS, extras=extras)
    fresh = _prefill_logits(torch, bundle, model, tokens, extras,
                            f"serve-trained {arch} checkpoint")
    err, close = _close(served, fresh, MODEL_TOL)
    print(f"serve-trained {arch} B {SERVE_B} at {seq} tokens from the trained snapshot "
          f"({bd}): weights equal the checkpoint's {same}; prefill {st.prefill_s * 1e3:.2f} ms, "
          f"{st.decode_s / st.tokens * 1e3:.3f} ms a step; prefill logits against the "
          f"checkpoint's max|diff| {err:.3e} (tol {MODEL_TOL}); first tokens "
          f"{out[:, 0].tolist()}; tokens of row 0 {out[0].tolist()}, equal to generate's on the "
          f"checkpoint {np.array_equal(out, want)}; launches flash, decode {got} (expected "
          f"{want_launches})")
    if not (same and close and np.array_equal(out, want)):
        _fail(f"serve-trained {arch}: the served snapshot is not the trained checkpoint")
    if got != want_launches:
        _fail(f"serve-trained {arch}: launches {got} != {want_launches}")
    del model, state, trained
    _free(torch)
    print(f"phase serve-trained {arch}: {time.perf_counter() - t0:.1f} s")


def train_serve_phases(torch, dev):
    """Phases 42-47 in their order; returns what the kernels line reads: the
    training runs' launches and the B 8 engines' launches, by architecture."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckdir:
        trained = {arch: full_train_phase(torch, dev, arch, ckdir) for arch in (ENCDEC, VISION)}
        xlstm_train_phase(torch, dev)
        engines = {arch: engine_b8_phase(torch, arch, max_seq) for arch, max_seq in ENGINES_B8}
        for arch, max_seq in ENGINES_B8:
            batch_rows_phase(torch, dev, arch, max_seq)
        for arch in (ENCDEC, VISION):
            trained_serve_phase(torch, arch, trained[arch][2])
    print(f"phases 42-47 (train and serve at B {SERVE_B}): {time.perf_counter() - t0:.1f} s")
    return {arch: t[0] for arch, t in trained.items()}, engines


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    for lib in ("flash_attention", "flash_attention_bwd"):
        sass = _sass_counts(lib)
        print(f"sass {lib}: " + ("not measured (no cuobjdump)" if sass is None else
                                 ", ".join(f"{op} {n}" for op, n in sass.items())))
        # the bf16 backward runs on the tensor cores with TMA tiles
        if lib == "flash_attention_bwd" and (sass is None or min(sass.values()) == 0):
            _fail(f"sass {lib}: no HGMMA / UTMALDG ({sass})")

    from repro_torch.config import get_config

    timed = kernel_phase(torch, dev)
    fc_flash = forecaster_flash(torch, dev)
    train_timed = flash_bwd_phase(torch, dev)
    timed["ssm_scan"] = ssm_kernel_phase(torch, dev)
    ssm_timed = ssm_bwd_phase(torch, dev)
    model_phase(torch, dev, dataclasses.replace(get_config(ARCH), dtype="float32",
                                                param_dtype="float32"), f"{ARCH} fp32")
    launches = engine_phase(torch)
    _free(torch)
    hybrid_model_phase(torch, dev)
    launches["ssm_scan"] = hybrid_serve_phase(torch, dev)
    hybrid_engine_phase(torch)
    cluster_phase(torch, dev)
    launches["cluster_step"], timed["cluster_step"] = batch_phase(torch, dev)
    _free(torch)
    xlstm_model_phase(torch, dev)
    xlstm_engine_phase(torch)
    facade_phase(torch)
    launcher_phase()
    drivers_phase()
    gym_kernel_phase(torch, dev)
    gym_launches, gym_timed = gym_phase(torch, dev)
    fc_launches = forecaster_phase(torch, dev)
    w = encdec_phase(torch, dev)
    vl = vision_phase(torch, dev)
    chain_phase(torch)
    train_grad_phase(torch, dev, get_config(ARCH), ARCH, TRAIN_SHAPE)
    train_launches, granite_train = granite_train_phase(torch, dev)
    train_grad_phase(torch, dev, hybrid_train_cfg(), f"{HYBRID} x{HYBRID_TRAIN_LAYERS}",
                     HYBRID_GRAD_SHAPE)
    hybrid_train_launches, hybrid_train = hybrid_train_phase(torch, dev)
    fc_train_launches = forecaster_train_phase(torch, dev)
    smoke_launches = smoke_train_phase(torch, dev)
    lifecycle_phase(torch, dev)
    guard_phase(torch, dev)
    ep_phase(torch, dev)
    dryrun_phase(torch, granite_train["held"], hybrid_train["held"])
    roofline_phase(torch, {f"{ARCH} train": granite_train["step_s"],
                           f"{ARCH} prefill": launches["prefill_s"],
                           f"{HYBRID} x{HYBRID_TRAIN_LAYERS} train": hybrid_train["step_s"]})
    gspmd_phase(torch, dev, granite_train["step_s"])
    gsd_launches, split_launches, timed_stats = gspmd_decode_phase(torch, dev)
    served = {shape: arch_phase(torch, dev, arch, fp32_layers, bf16_layers)[0]
              for arch, shape, fp32_layers, bf16_layers in ARCHS}
    moe_layer_phase(torch, dev)
    long_timed = long_kernel_phase(torch, dev)
    p1_flash, _ = prefill_32k_phase(torch, dev, long_timed)
    p2_launches, _ = decode_32k_phase(torch, dev)
    p3_launches, _ = train_4k_phase(torch, dev)
    ring = {label: long_ring_phase(torch, dev, label, cfg)[0] for label, cfg in ring_cfgs()}
    trained, engines = train_serve_phases(torch, dev)
    # a kernel on several main paths: each path's launches (counts set to 0
    # just before it, read just after) and its numbers at that path's shape.
    # whisper's prefill runs its 32 layers' flash calls at three shapes
    # (encoder, decoder self, cross: 96 a prefill, gated exactly) and its
    # decode steps two (self, cross: 64 a step), so each shape takes its share
    def at(kernel, shape, name):
        return timed[(kernel, shape, name)]

    # each new serve's B 1 requests and its SERVE_B request, at their shapes
    def served_paths(kernel, i, names):
        return [(f"{shape}-serve{'' if b == 1 else f'-b{b}'}", served[shape][b][i],
                 at(kernel, shape, name))
                for shape in SERVED_SHAPES for b, name in zip((1, SERVE_B), names)]

    # the long shapes' paths (phases 38-41) at their own shapes
    def long_at(kernel, shape, name):
        return long_timed[(kernel, shape, name)]

    # the training paths' (phase 18: granite's, the forecaster's, train_4k's)
    def train_at(kind, shape, name):
        return train_timed[(kind, shape, name)]

    ring_names = [(label, "danube" if label == RING_ARCH else "jamba") for label in ring]
    paths = {"flash_attention": [
                 ("engine", launches["flash_attention"], at("flash_attention", "granite", "prefill")),
                 ("forecaster", fc_launches, fc_flash[1]),
                 *((f"whisper-{name}", w["flash_attention"] // 3,
                    at("flash_attention", "whisper", name))
                   for name in ("encoder", "decoder", "cross")),
                 ("internvl2", vl["flash_attention"], at("flash_attention", "internvl2", "prefill")),
                 ("granite-train", train_launches[0], train_at("fwd", "granite", "train")),
                 ("forecaster-train", fc_train_launches[0],
                  train_at("fwd", "forecaster", "train")),
                 *served_paths("flash_attention", 1, ("prefill", "prefill_b8")),
                 ("prefill_32k", p1_flash, long_at("flash_attention", "granite", "prefill_32k")),
                 ("decode_32k", p2_launches[1],
                  long_at("flash_attention", "granite", "decode_32k_prefill")),
                 ("train_4k", p3_launches[0], train_at("fwd", "granite", "train_4k")),
                 *((f"long_500k-{label}", ring[label][1],
                    long_at("flash_attention", shape, "ring_prefill"))
                   for label, shape in ring_names),
                 *((f"whisper-train-{name}", trained[ENCDEC][0] // 3,
                    train_at("fwd", "whisper", f"train_{name}"))
                   for name in ("encoder", "decoder", "cross")),
                 ("internvl2-train", trained[VISION][0], train_at("fwd", "internvl2", "train")),
                 ("granite-engine-b8", engines[ARCH]["flash_attention"],
                  at("flash_attention", "granite", "prefill_b8")),
                 *((f"whisper-engine-b8-{name}", engines[ENCDEC]["flash_attention"] // 3,
                    at("flash_attention", "whisper", f"{name}_b8"))
                   for name in ("encoder", "decoder", "cross")),
                 ("internvl2-engine-b8", engines[VISION]["flash_attention"],
                  at("flash_attention", "internvl2", "prefill_b8"))],
             "flash_attention_bwd": [
                 ("granite-train", train_launches[1], train_at("bwd", "granite", "train")),
                 ("forecaster-train", fc_train_launches[1],
                  train_at("bwd", "forecaster", "train")),
                 ("train_4k", p3_launches[1], train_at("bwd", "granite", "train_4k")),
                 *((f"whisper-train-{name}", trained[ENCDEC][1] // 3,
                    train_at("bwd", "whisper", f"train_{name}"))
                   for name in ("encoder", "decoder", "cross")),
                 ("internvl2-train", trained[VISION][1], train_at("bwd", "internvl2", "train"))],
             "ssm_scan": [
                 ("hybrid-serve", launches["ssm_scan"], timed["ssm_scan"]),
                 ("jamba-train", hybrid_train_launches[2], ssm_timed[("fwd", "jamba")]),
                 ("jamba-smoke-train", smoke_launches[2], ssm_timed[("fwd", "smoke")]),
                 (f"long_500k-{HYBRID} x{HYBRID_LAYERS}", ring[f"{HYBRID} x{HYBRID_LAYERS}"][0],
                  long_at("ssm_scan", "jamba", "ring_prefill"))],
             "ssm_scan_bwd": [
                 ("jamba-train", hybrid_train_launches[3], ssm_timed[("bwd", "jamba")]),
                 ("jamba-smoke-train", smoke_launches[3], ssm_timed[("bwd", "smoke")])],
             "decode_attention": [
                 ("engine", launches["decode_attention"], at("decode_attention", "granite", "decode")),
                 ("gspmd-decode", gsd_launches, at("decode_attention", "granite", "decode")),
                 *((f"whisper-{name}", w["decode_attention"] // 2,
                    at("decode_attention", "whisper", name)) for name in ("self", "cross")),
                 ("internvl2", vl["decode_attention"], at("decode_attention", "internvl2", "decode")),
                 *served_paths("decode_attention", 2, ("decode", "decode_b8")),
                 ("decode_32k", p2_launches[2], long_at("decode_attention", "granite", "decode_32k")),
                 *((f"long_500k-{label}", ring[label][2], long_at("decode_attention", shape, "ring"))
                   for label, shape in ring_names),
                 ("granite-engine-b8", engines[ARCH]["decode_attention"],
                  at("decode_attention", "granite", "decode_b8")),
                 *((f"whisper-engine-b8-{name}", engines[ENCDEC]["decode_attention"] // 2,
                    at("decode_attention", "whisper", f"{name}_b8")) for name in ("self", "cross")),
                 ("internvl2-engine-b8", engines[VISION]["decode_attention"],
                  at("decode_attention", "internvl2", "decode_b8"))],
             "cluster_step": [("sweep", launches["cluster_step"], timed["cluster_step"]),
                              ("gym", gym_launches, gym_timed)]}
    timed = {"flash_attention": at("flash_attention", "granite", "prefill"),
             "decode_attention": at("decode_attention", "granite", "decode"),
             "ssm_scan": timed["ssm_scan"], "cluster_step": timed["cluster_step"],
             "flash_attention_bwd": train_at("bwd", "granite", "train"),
             "ssm_scan_bwd": ssm_timed[("bwd", "jamba")],
             "decode_attention_stats": timed_stats}

    # the backwards have no TPU kernel: the JAX package trains through
    # jax.vjp of its jnp flash attention (ops.py:46, _flash_reference) and of
    # its jnp two-level scan (ops.py:146)
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:76",
                "flash_attention_bwd": "src/repro/kernels/ops.py:46",
                "decode_attention": "src/repro/kernels/decode_attention.py:57",
                "cluster_step": "src/repro/kernels/cluster_step.py:237",
                "ssm_scan": "src/repro/kernels/ssm_scan.py:62",
                "ssm_scan_bwd": "src/repro/kernels/ops.py:146",
                "decode_attention_stats": "src/repro/kernels/decode_attention.py:57"}
    def numbers(t):
        return {"max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}

    # the decode kernel's statistics instantiation (the combine writes the
    # fp32 output and each row's (m, l)) runs where a mesh splits a cache's
    # rows: its launches are phase 31b's split path (one process standing for
    # the ranks of such a world; a one-card mesh splits nothing)
    launches["decode_attention_stats"] = split_launches
    sources = {"decode_attention_stats": "decode_attention"}
    kernels = []
    for name, t in timed.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{sources.get(name, name)}.cu",
                 "replaces": replaces[name], "launches": launches.get(name), **numbers(t)}
        if name in paths:
            entry["launches"] = sum(n for _, n, _ in paths[name])
            entry["paths"] = [{"path": p, "launches": n, **numbers(pt)}
                              for p, n, pt in paths[name]]
        kernels.append(entry)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
