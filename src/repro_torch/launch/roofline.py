"""Roofline for the H100 (port of ``repro.launch.roofline``).

For each (arch × shape) the three roofline terms of one device, on a mesh of
``chips(mesh)`` H100s (``CHIPS``, one, by default):

    compute    = sum over dtypes of FLOPs / that dtype's peak, or the
                 exponentials over the special-function units, the larger
    memory     = bytes / HBM rate
    collective = all-reduce bytes a device sends / NVLink rate

Where the counts come from (the reference reads compiled HLO instead):

  1. **The meta pass** (``launch.dryrun.meta_entry``): the entry point runs
     once on meta tensors at full size with no rules context, so every op is
     the whole model's.  ``torch.utils.flop_counter.FlopCounterMode`` counts
     its FLOPs; a small ``TorchDispatchMode`` (:class:`OpBytes`) adds every
     aten op's input and output bytes and splits the FLOPs by dtype.  Those
     are *eager* bytes: each op reads its inputs and writes its outputs once,
     nothing is fused, a view moves nothing and a broadcast input counts its
     stored elements only.
  2. **The hand kernels, analytically**: their meta branches launch and count
     nothing, so each call's work is added from :func:`kernel_work`, with the
     formulas ``chip_smoke.py``'s kernel bounds use (:func:`flash_work`,
     :func:`decode_work`, :func:`ssm_scan_work` and the backwards'), a query
     /key pair or a scan element at a time.  Decode counts the whole cache
     as valid (the position is data the meta pass does not have).
  3. **The xLSTM recurrences, analytically**: the meta pass walks one time
     step for all (``models/xlstm.py::_walk``), so the reference's
     recurrence terms are added on top, as it adds them to a loop body that
     HLO counts once.
  4. **Across chips**: global FLOPs and bytes are divided by the chip count,
     which assumes a perfect split; the collective term is the EP combine's
     all-reduce bytes a device sends, from the dry run's meta pass under the
     mesh's rules.

Peaks: the H100 SXM data sheet (dense, 700 W).  :func:`analytic_loop_costs`
and :func:`model_flops` keep the reference's arithmetic and names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.config import (ARCH_IDS, SHAPES, InputShape, get_config, get_shape,
                                supports_shape)
from repro_torch.launch.dryrun import dry_run, mesh_name, meta_entry
from repro_torch.launch.mesh import MeshShape, chips
from repro_torch.models import registry
from repro_torch.training.optimizer import OptimizerConfig, apply_updates_, init_opt_state
from repro_torch.training.train_loop import decays, param_tree

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s per direction, NVLink 4 (18 links x 25 GB/s)
# exponentials: the special-function units' 16 per clock per SM, 132 SMs, 1.98 GHz boost
PEAK_EXPS = 16 * 132 * 1.98e9
# the default mesh's chips (:func:`one_chip`); the reference's CHIPS is its
# 16 x 16 TPU pod, and ``analyze(cfg, shape, mesh)`` takes any other mesh
CHIPS = 1


def one_chip() -> MeshShape:
    """One H100, as a (1, 1) data x model mesh."""
    return MeshShape((1, 1), ("data", "model"))


# --------------------------------------------------------------------------- #
# the reference's analytic terms (its names and arithmetic)
# --------------------------------------------------------------------------- #


def _train_mult(kind: str) -> float:
    return 3.0 if kind == "train" else 1.0


def analytic_loop_costs(cfg, shape) -> Dict[str, float]:
    """Global FLOPs/bytes of inner time loops (counted once by HLO)."""
    b, s = shape.global_batch, shape.seq_len
    window = registry.resolve_window(cfg, shape)
    m = _train_mult(shape.kind)
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    flops = 0.0
    nbytes = 0.0
    if shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}   # decode has no inner time loops
    pat = cfg.layer_pattern
    for kind in pat:
        if kind == "A":
            skv = min(window, s) if window else s
            causal = 0.5 if (window is None) else 1.0
            f = 4.0 * b * cfg.num_heads * cfg.head_dim * s * skv * causal
            flops += f * m
            nq = max(1, s // 1024)
            nbytes += m * b * (nq * skv * 2 * cfg.kv_dim
                               + 2 * s * cfg.q_dim) * itemsize
        elif kind == "M":
            ssm = cfg.ssm
            d_in = ssm.expand * cfg.d_model
            flops += m * 9.0 * b * s * d_in * ssm.d_state
            nbytes += m * 2.0 * b * s * (2 * d_in + 2 * ssm.d_state) * 4
        elif kind in ("L", "S"):
            x = cfg.xlstm
            d_in = int(x.proj_factor * cfg.d_model)
            dh = d_in // x.num_heads
            flops += m * 10.0 * b * s * d_in * dh
            nbytes += m * 2.0 * b * s * 2 * d_in * 4
    if cfg.encoder is not None:
        e = cfg.encoder
        f_frames = e.num_frames
        # encoder self-attn (non-causal) + decoder cross-attn loops
        flops += m * (4.0 * b * e.num_heads * (e.d_model // e.num_heads)
                      * f_frames * f_frames) * e.num_layers
        flops += m * (4.0 * b * cfg.num_heads * cfg.head_dim * s * f_frames
                      ) * cfg.num_layers
    return {"flops": flops, "bytes": nbytes}


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params (MoE)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one decoded token


def _xlstm_recurrence(cfg, shape) -> Tuple[float, float]:
    """The reference's xLSTM recurrence terms (FLOPs, bytes) of
    :func:`analytic_loop_costs`: what the meta pass's one walked step stands
    for."""
    if shape.kind == "decode" or cfg.xlstm is None:
        return 0.0, 0.0
    m = _train_mult(shape.kind)
    b, s = shape.global_batch, shape.seq_len
    x = cfg.xlstm
    d_in = int(x.proj_factor * cfg.d_model)
    dh = d_in // x.num_heads
    n = sum(1 for kind in cfg.layer_pattern if kind in ("L", "S"))
    return n * m * 10.0 * b * s * d_in * dh, n * m * 2.0 * b * s * 2 * d_in * 4


# --------------------------------------------------------------------------- #
# the hand kernels' work: chip_smoke.py's bounds and the roofline read these
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Work:
    """One kernel call's (or a sum of calls') FLOPs, exponentials and bytes
    (each input read once, each output written once); ``dtype`` names the
    FLOPs' peak."""
    flops: float = 0.0
    exps: float = 0.0
    bytes: float = 0.0
    dtype: str = "float32"

    def plus(self, other: "Work", n: int = 1) -> "Work":
        """This work and ``n`` calls of ``other`` (of the same dtype)."""
        return Work(self.flops + n * other.flops, self.exps + n * other.exps,
                    self.bytes + n * other.bytes, other.dtype)


def bound(work: Work) -> Tuple[float, str]:
    """Least seconds for ``work``: bytes over HBM's rate against operations,
    the larger of the FLOPs over the dtype's peak and the exponentials over
    the special-function units' rate; and which of the two bounds it."""
    t_ops = max(work.flops / PEAK_FLOPS[work.dtype], work.exps / PEAK_EXPS)
    t_bytes = work.bytes / HBM_BW
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def attention_pairs(sq: int, skv: int, *, causal: bool, window: Optional[int]) -> int:
    """Valid (query, key) position pairs of ``kernels.ref.attention_mask`` for
    queries at the last ``sq`` of the keys' positions and keys at
    ``arange(skv)``."""
    q0 = skv - sq
    total = 0
    for q in range(q0, q0 + sq):
        hi = min(skv - 1, q) if causal else skv - 1
        lo = max(0, q - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def _dtype(itemsize: int) -> str:
    return "bfloat16" if itemsize == 2 else "float32"


def flash_work(b, sq, skv, hq, hkv, d, itemsize, pairs, *, stats=False) -> Work:
    """The flash forward: ``pairs`` valid position pairs of each (batch,
    head); q·k and p·v are 4·D FLOPs and one exponential a pair.  Bytes: q,
    k, v, the output, both position vectors, and with ``stats`` (m, 1/l)."""
    n = b * hq * pairs
    nbytes = (2 * b * sq * hq + 2 * b * skv * hkv) * d * itemsize + 4 * (sq + skv)
    if stats:
        nbytes += 2 * b * hq * sq * 4
    return Work(4.0 * n * d, float(n), float(nbytes), _dtype(itemsize))


def flash_bwd_work(b, sq, skv, hq, hkv, d, itemsize, pairs) -> Work:
    """The flash backward: dq, dk, dv and the recomputed S and dP, five
    D-long products (10·D FLOPs) and one exponential a pair.  Bytes: q, k,
    v, out, dout, m, 1/l, dq, dk, dv and the positions."""
    n = b * hq * pairs
    nbytes = ((4 * b * sq * hq + 4 * b * skv * hkv) * d * itemsize
              + 2 * b * hq * sq * 4 + 4 * (sq + skv))
    return Work(10.0 * n * d, float(n), float(nbytes), _dtype(itemsize))


def decode_work(b, s, hq, hkv, d, itemsize, n_valid, *, stats=False) -> Work:
    """Decode attention over ``n_valid`` valid cache rows (summed over the
    batch): 4·D FLOPs and one exponential a row and q head; bytes: q, the
    output, the mask and the valid rows of both caches; with ``stats`` the
    output in fp32 and each row's (m, l)."""
    out = b * hq * (4 * d + 8) if stats else b * hq * d * itemsize
    nbytes = b * hq * d * itemsize + out + b * s + 2 * n_valid * hkv * d * itemsize
    return Work(4.0 * n_valid * hq * d, float(n_valid * hq), float(nbytes), _dtype(itemsize))


def ssm_scan_work(bt, t, din, n, itemsize, *, checkpoints=False) -> Work:
    """The selective scan: 6 fp32 FLOPs and one exponential a (step,
    channel, state).  Bytes: u, B, C, y in the activations' dtype; delta, A,
    D, h0, h_T (and the checkpoints) in fp32."""
    from repro_torch.kernels.ssm_scan import n_chunks

    e = bt * t * din * n
    nbytes = ((2 * bt * t * din + 2 * bt * t * n) * itemsize + bt * t * din * 4
              + din * n * 4 + din * 4 + 2 * bt * din * n * 4)
    if checkpoints:
        nbytes += bt * n_chunks(t) * din * n * 4
    return Work(6.0 * e, float(e), float(nbytes))


def ssm_scan_bwd_work(bt, t, din, n, itemsize) -> Work:
    """The scan's backward: 14 fp32 FLOPs and one exponential a (step,
    channel, state).  Bytes: u, delta, A, B, C, D, the checkpoints, dy and
    dh_T in; du, ddelta, dA, dB, dC, dD and dh0 out."""
    from repro_torch.kernels.ssm_scan import n_chunks

    e = bt * t * din * n
    nbytes = ((3 * bt * t * din + 4 * bt * t * n) * itemsize + 2 * bt * t * din * 4
              + 2 * (din * n + din) * 4 + 2 * bt * din * n * 4
              + bt * n_chunks(t) * din * n * 4)
    return Work(14.0 * e, float(e), float(nbytes))


def kernel_work(cfg, shape: InputShape) -> Dict[str, Work]:
    """Every hand kernel's work in one call of the shape's entry point, by
    kernel: attention layers run flash (prefill; the train step's forward
    with statistics, twice a layer under remat, and its backward) or decode
    attention (over the whole cache); Mamba layers the scan (decode steps
    take the plain ``ssm_step``)."""
    b, s, kind = shape.global_batch, shape.seq_len, shape.kind
    it = 2 if cfg.dtype == "bfloat16" else 4
    fwd = 2 if (kind == "train" and cfg.remat) else 1
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {name: Work(dtype=_dtype(it)) for name in (
        "flash_attention", "flash_attention_bwd", "decode_attention")}
    out["ssm_scan"], out["ssm_scan_bwd"] = Work(), Work()

    def add(name, work, n):
        out[name] = out[name].plus(work, n)

    def attend(n, sq, skv, h, g, d, causal, window):
        if kind == "decode":
            return add("decode_attention", decode_work(b, skv, h, g, d, it, b * skv), n)
        pairs = attention_pairs(sq, skv, causal=causal, window=window)
        add("flash_attention", flash_work(b, sq, skv, h, g, d, it, pairs,
                                          stats=kind == "train"), n * fwd)
        if kind == "train":
            add("flash_attention_bwd", flash_bwd_work(b, sq, skv, h, g, d, it, pairs), n)

    if cfg.encoder is not None:
        e = cfg.encoder
        f, layers = e.num_frames, cfg.num_layers
        if kind != "decode":
            attend(e.num_layers, f, f, e.num_heads, e.num_heads, e.d_model // e.num_heads,
                   False, None)
        attend(layers, 1 if kind == "decode" else s, s, hq, hkv, hd, True, None)
        attend(layers, 1 if kind == "decode" else s, f, hq, hkv, hd, False, None)
        return out
    window = registry.resolve_window(cfg, shape)
    pat = cfg.layer_pattern
    n_a, n_m = pat.count("A"), pat.count("M")
    if n_a:
        skv = (min(window, s) if window else s) if kind == "decode" else s
        attend(n_a, 1 if kind == "decode" else s, skv, hq, hkv, hd, True, window)
    if n_m and kind != "decode":
        din, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
        add("ssm_scan", ssm_scan_work(b, s, din, n, it, checkpoints=kind == "train"),
            n_m * fwd)
        if kind == "train":
            add("ssm_scan_bwd", ssm_scan_bwd_work(b, s, din, n, it), n_m)
    return out


# --------------------------------------------------------------------------- #
# the meta pass's FLOPs and bytes
# --------------------------------------------------------------------------- #

# ops that move no bytes: allocation without a write, and aliasing reshapes
_FREE = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
         torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
         torch.ops.aten._unsafe_view}


def _stored_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes, counting a broadcast (stride-0) dim once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class OpBytes(TorchDispatchMode):
    """Adds each aten op's input and output bytes (views and empty
    allocations move none), and its FLOPs (``FlopCounterMode``'s formulas)
    by the dtype of its first input."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return out
        self.bytes += sum(_stored_bytes(t) for t in _tensors((args, kwargs, out)))
        if packet in flop_registry:
            first = next(_tensors(args))
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = str(first.dtype).replace("torch.", "")
            self.flops[dt] = self.flops.get(dt, 0.0) + n
        return out


def count_meta_pass(cfg, shape: InputShape) -> Dict[str, Any]:
    """FLOPs (total and by dtype) and eager bytes of one meta pass of the
    shape's entry point over the whole model (no rules context)."""
    bundle = registry.build(cfg, shape, device="meta")
    run = meta_entry(bundle, shape)
    counter, ops = FlopCounterMode(display=False), OpBytes()
    with counter, ops:
        run()
    return {"flops": float(counter.get_total_flops()), "flops_by_dtype": ops.flops,
            "bytes": float(ops.bytes)}


def update_bytes(cfg) -> float:
    """Eager bytes of one in-place AdamW update of the whole model
    (``training.optimizer.apply_updates_`` as the train step calls it), on
    meta tensors: the train step's bytes that a fused update would cut."""
    tree = param_tree(registry.build(cfg, device="meta").empty())
    grads = {k: torch.empty_like(v) for k, v in tree.items()}
    state = init_opt_state(tree)
    ops = OpBytes()
    with ops:
        apply_updates_(OptimizerConfig(), tree, grads, state, decay=decays(tree))
    return float(ops.bytes)


def analyze(cfg, shape: InputShape, mesh=None) -> Dict[str, Any]:
    """The roofline record of ``cfg`` at ``shape`` on ``mesh`` (one H100 by
    default); no skip check."""
    mesh = mesh or one_chip()
    n_chips = chips(mesh)
    t0 = time.perf_counter()
    meta = count_meta_pass(cfg, shape)
    kernels = kernel_work(cfg, shape)
    rec_flops, rec_bytes = _xlstm_recurrence(cfg, shape)
    update = update_bytes(cfg) if shape.kind == "train" else 0.0
    coll = 0.0
    if n_chips > 1 and cfg.moe is not None:
        coll = dry_run(cfg, shape, mesh)["collective_bytes_total"]
    measure_s = time.perf_counter() - t0

    by_dtype = dict(meta["flops_by_dtype"])
    by_dtype["float32"] = by_dtype.get("float32", 0.0) + rec_flops   # fp32 recurrences
    act = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    exps = 0.0
    nbytes = meta["bytes"] + rec_bytes
    for w in kernels.values():
        by_dtype[w.dtype] = by_dtype.get(w.dtype, 0.0) + w.flops
        exps += w.exps
        nbytes += w.bytes
    flops = sum(by_dtype.values())
    compute_s = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"]) for dt, f in by_dtype.items())
    compute_s = max(compute_s, exps / PEAK_EXPS) / n_chips
    memory_s = nbytes / n_chips / HBM_BW
    coll_s = coll / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    bound_s = max(terms.values())
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": mesh_name(mesh),
        "status": "ok", "measure_s": round(measure_s, 2),
        "flops_per_device": flops / n_chips,
        "flops_by_dtype": {k: v / n_chips for k, v in by_dtype.items()},
        "flop_counter_flops": meta["flops"],
        "bytes_per_device": nbytes / n_chips,
        "update_bytes_per_device": update / n_chips,
        "collective_bytes_per_device": coll,
        "kernel_work": {k: dataclasses.asdict(w) for k, w in kernels.items() if w.flops},
        "analytic_loop_flops_global": rec_flops + sum(w.flops for w in kernels.values()),
        **terms,
        "bound_s": bound_s,
        "dominant": dominant.replace("_s", ""),
        "model_flops_global": mf,
        "useful_flops_ratio": round(mf / max(flops, 1.0), 4),
        "mfu_upper_bound": round((mf / n_chips / PEAK_FLOPS[act]) / max(bound_s, 1e-12), 4),
    }


def analyze_pair(arch: str, shape_name: str, *, dryrun_mem: Optional[dict] = None,
                 mesh=None) -> Dict[str, Any]:
    """The reference's entry: ``arch`` x ``shape_name`` on ``mesh`` (one H100
    by default); ``dryrun_mem`` (the dry run's ``bytes_per_device``) is
    carried into the record as ``mem_per_device``, as the reference does."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped"}
    rec = analyze(cfg, shape, mesh)
    rec["arch"] = arch
    if dryrun_mem:
        rec["mem_per_device"] = dryrun_mem
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' reduced variants at reduced shapes (seconds on a CPU)")
    ap.add_argument("--out", default="roofline_results.json")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    for a in archs:
        for s in shapes:
            try:
                if args.smoke:
                    from repro_torch.config import reduced, reduced_shape
                    rec = analyze(reduced(get_config(a)), reduced_shape(get_shape(s)))
                else:
                    rec = analyze_pair(a, s)
            except Exception as e:  # noqa: BLE001 — report, keep going
                rec = {"arch": a, "shape": s, "status": "error", "error": repr(e)[:400]}
            results.append(rec)
            print(json.dumps(rec), flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    ok = [r for r in results if r["status"] == "ok"]
    print(f"# roofline: {len(ok)} ok / {len(results)}")


if __name__ == "__main__":
    main()
