"""``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished invokes' rows is drawn from the seed: one row of every invoke
that a cold or restored replica served first, then rows of the others, up to
the mix's ``check.rows``.  The reference reads each row's prompt and served
tokens and gives its logits at the positions that chose them; the number
compared is the widest gap by which a served token's logit lies below the
reference's best there (0 where every token is the reference's argmax).
The control reads the same gap for the tokens that the fp8 reference puts
first.  ``ENGINE_SEED`` is the seed the router's engines draw their weights
from: ``InferenceEngine``'s default, since the router passes none.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


ENGINE_SEED = 0


def sample_rows(served, cell, seed: int) -> List[Tuple[int, int]]:
    """(index into ``served``, row) pairs: one row of each cold invoke, then
    others drawn from the seed, ``check.rows`` in all (fewer where fewer
    rows finished)."""
    batch = cell.traffic["batch"]
    rng = np.random.default_rng([seed % 2**63, 3])
    done = [i for i, s in enumerate(served) if s.tokens is not None]
    picked = [(i, int(rng.integers(batch))) for i in done if served[i].record.cold]
    taken = set(picked)
    rest = [(i, r) for i in done for r in range(batch) if (i, r) not in taken]
    want = max(0, cell.traffic["check"]["rows"] - len(picked))
    for k in rng.permutation(len(rest))[:want]:
        picked.append(rest[k])
    return picked


def row_arrays(served, rows) -> Tuple[np.ndarray, np.ndarray]:
    prompts = np.stack([served[i].prompt[r] for i, r in rows])
    tokens = np.stack([served[i].tokens[r] for i, r in rows])
    return prompts, tokens


def widest_gap(ref_logits, tokens) -> float:
    """The largest amount by which a token's reference logit lies below the
    reference's best at its position."""
    import torch

    t = torch.as_tensor(tokens, dtype=torch.int64, device=ref_logits.device)
    got = ref_logits.gather(-1, t[..., None])[..., 0]
    return float((ref_logits.max(-1).values - got).max())


def malformed(served, cell) -> int:
    """Finished invokes whose tokens are not (batch, output_tokens) ids of
    the vocabulary."""
    want = (cell.traffic["batch"], cell.traffic["output_tokens"])
    vocab = cell.config["vocab_size"]
    return sum(1 for s in served if s.tokens is not None
               and (s.tokens.shape != want or s.tokens.min() < 0 or s.tokens.max() >= vocab))


def judge(served, cell, seed: int, *, device) -> Dict[str, Tuple[float, float]]:
    """Each number compared, with its limit: failed and malformed invokes
    (0), the widest logit gap (the mix's ``check.logit_gap_limit``)."""
    from benchlib.reference import DenseLM

    checks: Dict[str, Tuple[float, float]] = {
        "failed": (float(sum(s.error is not None for s in served)), 0.0),
        "malformed": (float(malformed(served, cell)), 0.0)}
    rows = sample_rows(served, cell, seed) if checks["malformed"][0] == 0 else []
    if not rows:
        checks["rows_checked"] = (0.0, 1.0)
        return checks
    ref = DenseLM(cell.config, device=device, seed=ENGINE_SEED)
    prompts, tokens = row_arrays(served, rows)
    checks["logit_gap"] = (widest_gap(ref.logits(prompts, tokens), tokens),
                           float(cell.traffic["check"]["logit_gap_limit"]))
    return checks


def is_correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Every number at or under its limit, the rows-checked floor at or
    over it."""
    ok = True
    for name, (value, limit) in checks.items():
        ok &= value >= limit if name == "rows_checked" else value <= limit
    return ok and "logit_gap" in checks
