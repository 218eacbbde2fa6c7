"""Close the loop: event-log measurements → CostModel parameters.

``measured_costs`` inverts the cost model's RQ2 formulas on the
``startup`` events of a (typically real-engine) run:

  provision  = provision_base + provision_per_gb * mem_gb
  deps_load  = package_gb / (load_bandwidth * cpu_scale(mem))
  code_init  = compile_base * compile_cost / cpu_scale(mem)
  restore    = (deps_load + code_init) * snapshot_restore_frac
  paused     → resume_paused_s (the whole promote)

Each is solved for its parameter per sample using the function specs
recorded in the scenario's trace, then reduced by median — robust to the
occasional contention-inflated start.  Structural constants that cannot
be identified from one log (``cpu_mem_exponent``, ``base_memory_mb``,
``provision_per_gb_s`` when every function has one memory size) are
taken from the ``base`` model.  ``fidelity_report`` then scores any
CostModel against the same log: sim-predicted vs measured startup per
(function, tier).

Limitation: samples are attributed at face value — partial-loading
(``deps_fraction < 1``) scenarios would bias the bandwidth estimate, so
calibrate from the dedicated ``calib/engine_*`` cells, which use default
loading and a single uncontended worker.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional

from repro_torch.core.costmodel import CostModel
from repro_torch.core.lifecycle import FunctionSpec, WarmthTier

# tiers whose startup events exercise the full cold anatomy (img_cached
# only discounts PROVISION, so its other phases calibrate the same params)
_FULL_COLD = ("dead", "img_cached")


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _startup_samples(events: Iterable[Mapping[str, Any]]):
    for ev in events:
        if ev["kind"] == "startup":
            yield ev


def measured_costs(events: Iterable[Mapping[str, Any]],
                   functions: Mapping[str, FunctionSpec],
                   base: Optional[CostModel] = None) -> Dict[str, Any]:
    """Invert startup events into a ``from_calibration``-compatible dict.

    Only parameters with at least one sample appear; pair with a ``base``
    model (defaults supplied otherwise) for everything else.
    """
    base = base or CostModel()
    provision: List[tuple] = []            # (measured_s, mem_gb)
    runtime_init: Dict[str, List[float]] = {}
    bandwidth: List[float] = []
    compile_base: List[float] = []
    restore_frac: List[float] = []
    resume_paused: List[float] = []
    n_samples = 0
    n_skipped = 0

    # pass 1: the full-cold phases identify bandwidth + compile directly
    samples = list(_startup_samples(events))
    for ev in samples:
        fn = functions.get(ev["function"])
        if fn is None:
            n_skipped += 1
            continue
        n_samples += 1
        ph = ev["phases"]
        cpu = base._cpu_scale(fn.memory_mb)
        if ev["tier"] in _FULL_COLD:
            if ev["tier"] == "dead" and "provision" in ph:
                provision.append((ph["provision"],
                                  fn.memory_mb / 1024.0))
            if "runtime_init" in ph:
                runtime_init.setdefault(fn.runtime, []).append(
                    ph["runtime_init"])
            deps = ph.get("deps_load", 0.0)
            if deps > 0 and fn.package_mb > 0:
                bandwidth.append((fn.package_mb / 1024.0) / (deps * cpu))
            code = ph.get("code_init", 0.0)
            if code > 0 and fn.runtime != "python-eager" \
                    and fn.compile_cost > 0:
                compile_base.append(code * cpu / fn.compile_cost)
        elif ev["tier"] == "paused":
            resume_paused.append(ev["total"])
        elif ev["tier"] == "snapshot_ready":
            # the modeled restore path swaps RUNTIME_INIT for the "aot"
            # constant, so snapshot samples calibrate that entry
            if "runtime_init" in ph:
                runtime_init.setdefault("aot", []).append(
                    ph["runtime_init"])

    # pass 2: restore fraction is relative to the (just-)calibrated full
    # deps+code cost, so snapshot samples divide by calibrated magnitudes
    bw = _median(bandwidth) or base.load_bandwidth_gbps
    cb = _median(compile_base) if compile_base else base.compile_base_s
    for ev in samples:
        fn = functions.get(ev["function"])
        if fn is None or ev["tier"] != "snapshot_ready":
            continue
        ph = ev["phases"]
        cpu = base._cpu_scale(fn.memory_mb)
        restore = ph.get("deps_load", 0.0) + ph.get("code_init", 0.0)
        full = (fn.package_mb / 1024.0) / (bw * cpu)
        if fn.runtime != "python-eager":
            full += cb * fn.compile_cost / cpu
        if full > 0:
            restore_frac.append(restore / full)

    out: Dict[str, Any] = {}
    if provision:
        # one memory size identifies one parameter: keep the base slope
        # and solve for the intercept; if that clamps to zero (measured
        # provision below the slope term alone), refit the slope through
        # the origin instead so predicted == measured at the probed size
        pb = _median([p - base.provision_per_gb_s * gb
                      for p, gb in provision])
        if pb >= 0.0:
            out["provision_base_s"] = pb
        else:
            out["provision_base_s"] = 0.0
            out["provision_per_gb_s"] = _median(
                [p / gb for p, gb in provision if gb > 0])
    if bandwidth:
        out["load_bandwidth_gbps"] = bw
    if compile_base:
        out["compile_base_s"] = cb
    if runtime_init:
        out["runtime_init_s"] = {rt: _median(v)
                                 for rt, v in sorted(runtime_init.items())}
    if restore_frac:
        out["snapshot_restore_frac"] = _median(restore_frac)
    if resume_paused:
        out["resume_paused_s"] = _median(resume_paused)
    out["_meta"] = {
        "source": "repro_torch.analyze.calibrate.measured_costs",
        "startup_samples": n_samples,
        "skipped_unknown_function": n_skipped,
        "samples_per_param": {
            "provision_base_s": len(provision),
            "load_bandwidth_gbps": len(bandwidth),
            "compile_base_s": len(compile_base),
            "snapshot_restore_frac": len(restore_frac),
            "resume_paused_s": len(resume_paused),
        },
    }
    return out


def write_calibration(path: str, calib: Mapping[str, Any]) -> None:
    """Write a calibration dict in ``CostModel.from_calibration`` format."""
    with open(path, "w") as f:
        json.dump(dict(calib), f, indent=2, sort_keys=True)
        f.write("\n")


# --------------------------------------------------------------------------- #
# fidelity: sim-predicted vs measured startup, per (function, tier)
# --------------------------------------------------------------------------- #
def fidelity_report(events: Iterable[Mapping[str, Any]],
                    functions: Mapping[str, FunctionSpec],
                    cm: CostModel) -> List[Dict[str, Any]]:
    """Rows of ``{function, tier, n, measured_s, predicted_s, rel_err}``.

    ``measured_s`` is the median startup total from the log;
    ``predicted_s`` is ``cm.promote_breakdown(fn, tier)`` with no
    contention — rel_err is signed, (predicted - measured) / measured.
    """
    groups: Dict[tuple, List[float]] = {}
    for ev in _startup_samples(events):
        if ev["function"] in functions:
            groups.setdefault((ev["function"], ev["tier"]), []).append(
                ev["total"])
    rows: List[Dict[str, Any]] = []
    for (fn_name, tier), totals in sorted(groups.items()):
        fn = functions[fn_name]
        predicted = cm.promote_breakdown(
            fn, WarmthTier[tier.upper()]).total
        measured = _median(totals)
        rel = ((predicted - measured) / measured if measured
               else (0.0 if predicted == measured else float("inf")))
        rows.append({"function": fn_name, "tier": tier,
                     "n": len(totals), "measured_s": measured,
                     "predicted_s": predicted, "rel_err": rel})
    return rows


def format_fidelity(rows: List[Dict[str, Any]], *,
                    title: str = "fidelity") -> str:
    lines = [f"{title}: sim-predicted vs measured startup per "
             "(function, tier)"]
    lines.append(f"  {'function':24s} {'tier':14s} {'n':>4s} "
                 f"{'measured':>10s} {'predicted':>10s} {'err':>8s}")
    for r in rows:
        lines.append(
            f"  {r['function']:24s} {r['tier']:14s} {r['n']:4d} "
            f"{r['measured_s'] * 1e3:8.1f}ms {r['predicted_s'] * 1e3:8.1f}ms "
            f"{r['rel_err'] * 100:+7.1f}%")
    if not rows:
        lines.append("  (no startup events)")
    return "\n".join(lines)
