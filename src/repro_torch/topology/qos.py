"""Per-invocation QoS-class assignment from arrival weights.

``WorkloadSpec.qos_classes`` maps class names to arrival weights (the
faas-offloading-sim idiom: each incoming request belongs to a class with
probability proportional to its weight).  Assignment must be a *pure
function* of (seed, function, arrival time) — not of iteration order or
driver internals — so the scalar simulator and the fleet runner classify
every request identically, chain successors included, and per-class
ledger breakdowns can be recomputed after the fact from the request
records alone.

The hash is CRC32 (like :func:`repro_torch.experiments.spec.derive_seed`):
deterministic across processes, platforms, and Python hash randomization.
"""
from __future__ import annotations

import zlib
from typing import Mapping, Tuple

DEFAULT_CLASS = "default"


def class_names(classes: Mapping[str, float]) -> Tuple[str, ...]:
    """Deterministic class vocabulary: sorted names, or ("default",)."""
    if not classes:
        return (DEFAULT_CLASS,)
    return tuple(sorted(classes))


def assign_class(classes: Mapping[str, float], seed: int,
                 function: str, time: float) -> str:
    """Deterministically draw a QoS class for one invocation.

    Weights need not sum to 1 (they are normalized); non-positive total
    weight or an empty mapping falls back to :data:`DEFAULT_CLASS`.
    ``time`` enters via ``repr`` so the full float identity participates.
    """
    if not classes:
        return DEFAULT_CLASS
    names = sorted(classes)
    total = sum(max(0.0, float(classes[n])) for n in names)
    if total <= 0.0:
        return DEFAULT_CLASS
    h = zlib.crc32(f"{seed}:{function}:{time!r}".encode()) & 0xFFFFFFFF
    u = h / 2**32
    acc = 0.0
    for n in names:
        acc += max(0.0, float(classes[n])) / total
        if u < acc:
            return n
    return names[-1]
