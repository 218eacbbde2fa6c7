"""One general generator for every traffic mix.

A mix is a JSON file of parameters:

- ``functions``: ``count`` endpoints named ``<prefix>-<i>``, and under
  ``zipf_a`` their popularity (endpoint i drawn with weight (i + 1)^-a);
- ``batch``, ``prompt_len``, ``output_tokens``: each invoke's shape;
- ``arrivals``: ``{"kind": "poisson", "rate_per_s"}`` (open loop),
  ``{"kind": "bursts", "size", "period_s", "offset_s"}`` (open loop, bursts
  of ``size`` invokes due at once) or ``{"kind": "closed"}`` (one client,
  back to back);
- ``router``, ``setup``, ``trace`` and ``check``, read by ``benchlib.run``.

Every seed gets the same work: an open loop's inter-arrival gaps are the
exponential distribution's quantiles at (k + 1/2) / n and its endpoints are
drawn in exact Zipf proportions, both put in an order drawn from the seed;
prompts are token ids drawn uniformly from the seed.  So seeds differ in
order and in tokens, never in the amount of work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    index: int
    function: str
    due: Optional[float]          # seconds after the window opens; None: closed loop


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, *stream])


def functions(traffic: Dict[str, Any]) -> List[str]:
    f = traffic["functions"]
    return [f"{f['prefix']}-{i}" for i in range(f["count"])]


def popularity(traffic: Dict[str, Any]) -> np.ndarray:
    """Each endpoint's share of the invokes."""
    n = traffic["functions"]["count"]
    w = (np.arange(n) + 1.0) ** -float(traffic["functions"].get("zipf_a", 0.0))
    return w / w.sum()


def _exact_counts(shares: np.ndarray, n: int) -> np.ndarray:
    """``n`` split by ``shares``, rounded by largest remainder."""
    raw = shares * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(counts - raw)[: n - counts.sum()]:
        counts[i] += 1
    return counts


def is_closed(traffic: Dict[str, Any]) -> bool:
    return traffic["arrivals"]["kind"] == "closed"


def schedule(traffic: Dict[str, Any], seed: int, seconds: float) -> List[Request]:
    """The open loop's invokes due in ``[0, seconds)``, in due order."""
    arr = traffic["arrivals"]
    names = functions(traffic)
    rng = _rng(seed, 1)
    if arr["kind"] == "poisson":
        rate = float(arr["rate_per_s"])
        n = max(1, round(rate * seconds))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        due = np.cumsum(rng.permutation(gaps))
        who = rng.permutation(np.repeat(np.arange(len(names)),
                                        _exact_counts(popularity(traffic), n)))
        return [Request(i, names[who[i]], float(due[i])) for i in range(n)]
    if arr["kind"] == "bursts":
        starts = np.arange(float(arr["offset_s"]), seconds, float(arr["period_s"]))
        return [Request(b * arr["size"] + j, names[0], float(t))
                for b, t in enumerate(starts) for j in range(arr["size"])]
    raise ValueError(f"arrivals of kind {arr['kind']!r} have no schedule")


def closed_request(traffic: Dict[str, Any], index: int) -> Request:
    """The closed loop's ``index``-th invoke (the endpoints in turn)."""
    names = functions(traffic)
    return Request(index, names[index % len(names)], None)


def prompt(traffic: Dict[str, Any], vocab: int, seed: int, index: int) -> np.ndarray:
    """The ``index``-th invoke's (batch, prompt_len) int32 token ids."""
    shape = (traffic["batch"], traffic["prompt_len"])
    return _rng(seed, 2, index).integers(0, vocab, shape, dtype=np.int32)
