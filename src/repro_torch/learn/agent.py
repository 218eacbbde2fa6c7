"""Off-policy DQN keep-alive agent on the batch-sim gym (port of
``repro.learn.agent``).

One small Q-network (MLP over the gym's per-function observation,
:data:`~repro_torch.core.predictors.rl.ACTIONS` as the discrete action
lattice) is trained off-policy from a replay buffer: every gym epoch
contributes ``cells x functions`` independent transitions (the padding rows
are masked out).  Updates are standard DQN — Huber TD error against a
periodically-synced target network, epsilon-greedy behaviour policy — run
through the port's ``training/optimizer.py`` AdamW, with ``torch.autograd``
for the gradient.  The MLP has no TPU kernel: it is plain torch on the
gym's device.  The replay sampling and epsilon draw from
``np.random.default_rng(seed)``, as the reference's do, so both packages
sample the same transitions.

The trained policy exports as a *static* per-function warm-dwell map
(``RLLadder.attach_schedule`` replays it in every driver).  Two
distillations are offered and :func:`export_schedule` keeps whichever
scores higher on the gym's own reward:

* :func:`greedy_schedule` — modal greedy action per function over one
  greedy rollout;
* :func:`mean_q_schedule` — argmax over actions of the *mean Q-value*
  across the rollout's visited states.

:func:`evaluate_schedule` scores any exported map on the gym reward,
against :meth:`BatchSimGym.baseline_rewards` fixed-TTL rows.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.predictors.rl import ACTIONS
from repro_torch.device import resolve_device
from repro_torch.learn.gym import OBS_DIM, BatchSimGym
from repro_torch.training.checkpoint import tree_from_leaves
from repro_torch.training.optimizer import (OptimizerConfig, apply_updates,
                                            init_opt_state, tree_leaves)

SCHEDULE_VERSION = 1


# --------------------------------------------------------------------------- #
# Q-network
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DQNConfig:
    hidden: int = 64
    lr: float = 1e-3
    gamma: float = 0.9
    batch_size: int = 256
    buffer_size: int = 60_000
    target_sync: int = 100          # updates between target-net syncs
    eps_start: float = 1.0
    eps_end: float = 0.05
    updates_per_epoch: int = 8
    n_actions: int = len(ACTIONS)


def init_qnet(gen: torch.Generator, cfg: DQNConfig, *, device="cuda"):
    """Truncated-normal fan-in weights drawn on the CPU from ``gen`` (so a
    seed gives the same net on every device), zero biases."""
    from repro_torch.models import layers

    dev = resolve_device(device)
    h = cfg.hidden

    def dense(i, o):
        return {"w": layers.dense_init(gen, i, o, "float32", device="cpu").detach().to(dev),
                "b": torch.zeros((o,), dtype=torch.float32, device=dev)}

    return {"l1": dense(OBS_DIM, h), "l2": dense(h, h), "out": dense(h, cfg.n_actions)}


def apply_qnet(params, obs):
    """obs (..., OBS_DIM) -> Q-values (..., n_actions)."""
    h = torch.relu(obs @ params["l1"]["w"] + params["l1"]["b"])
    h = torch.relu(h @ params["l2"]["w"] + params["l2"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


# --------------------------------------------------------------------------- #
# replay buffer (flat numpy rings; transitions are per (cell, function))
# --------------------------------------------------------------------------- #
class Replay:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, OBS_DIM), np.float32)
        self.act = np.zeros((capacity,), np.int32)
        self.rew = np.zeros((capacity,), np.float32)
        self.nxt = np.zeros((capacity, OBS_DIM), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.size = 0
        self._at = 0

    def push(self, obs, act, rew, nxt, done) -> None:
        n = obs.shape[0]
        idx = (self._at + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.act[idx] = act
        self.rew[idx] = rew
        self.nxt[idx] = nxt
        self.done[idx] = done
        self._at = int((self._at + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.size, size=batch)
        return (self.obs[idx], self.act[idx], self.rew[idx],
                self.nxt[idx], self.done[idx])


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def _td_update_fn(cfg: DQNConfig, opt_cfg: OptimizerConfig):
    def loss_fn(params, target_params, obs, act, rew, nxt, done):
        q = apply_qnet(params, obs)
        qa = torch.gather(q, 1, act.long()[:, None])[:, 0]
        with torch.no_grad():
            q_next = torch.max(apply_qnet(target_params, nxt), dim=1).values
        tgt = rew + cfg.gamma * (1.0 - done) * q_next
        err = qa - tgt
        # Huber: quadratic near zero, linear tails (rewards span decades)
        return torch.mean(torch.where(torch.abs(err) <= 1.0, 0.5 * err * err,
                                      torch.abs(err) - 0.5))

    def update(params, target_params, opt_state, batch):
        live = tree_from_leaves(params, [p.detach().requires_grad_(True)
                                         for p in tree_leaves(params)])
        loss = loss_fn(live, target_params, *batch)
        grads = tree_from_leaves(params, torch.autograd.grad(loss, tree_leaves(live)))
        with torch.no_grad():
            params, opt_state, _ = apply_updates(opt_cfg, params, grads, opt_state)
        return params, opt_state, loss.detach()

    return update


def _greedy(params, obs) -> np.ndarray:
    with torch.no_grad():
        return torch.argmax(apply_qnet(params, obs), dim=-1).cpu().numpy()


def train_agent(gym: BatchSimGym, *, episodes: int = 30, seed: int = 0,
                cfg: Optional[DQNConfig] = None,
                log_every: int = 5, log_fn=print) \
        -> Tuple[dict, List[dict]]:
    """Epsilon-greedy episodes over the whole grid at once, on the gym's
    device; returns the trained Q-net params and a per-episode history
    (epsilon, mean loss, masked episode return)."""
    cfg = cfg or DQNConfig()
    actions = np.asarray(gym.actions, np.float32)
    if len(actions) != cfg.n_actions:
        raise ValueError(f"gym has {len(actions)} actions, "
                         f"DQNConfig expects {cfg.n_actions}")
    dev = gym.device
    total_updates = max(episodes * gym.num_epochs * cfg.updates_per_epoch, 1)
    opt_cfg = OptimizerConfig(lr=cfg.lr, warmup_steps=0,
                              total_steps=total_updates, weight_decay=0.0)
    params = init_qnet(torch.Generator().manual_seed(seed), cfg, device=dev)
    target = params
    opt_state = init_opt_state(params)
    update = _td_update_fn(cfg, opt_cfg)

    rng = np.random.default_rng(seed)
    replay = Replay(cfg.buffer_size)
    mask = gym.valid_mask.reshape(-1)
    history: List[dict] = []
    n_upd = 0

    for ep in range(episodes):
        eps = cfg.eps_start + (cfg.eps_end - cfg.eps_start) \
            * (ep / max(episodes - 1, 1))
        state, obs = gym.reset()
        ep_ret, losses = 0.0, []
        for _ in range(gym.num_epochs):
            o = obs.cpu().numpy()
            greedy = _greedy(params, obs)
            explore = rng.random(greedy.shape) < eps
            act = np.where(explore,
                           rng.integers(0, cfg.n_actions, greedy.shape),
                           greedy).astype(np.int32)
            state, obs, rew, _ = gym.step(state, actions[act])
            r = rew.cpu().numpy()
            ep_ret += float((r * gym.valid_mask).sum())
            done = 1.0 if gym.done(state) else 0.0
            replay.push(o.reshape(-1, OBS_DIM)[mask],
                        act.reshape(-1)[mask], r.reshape(-1)[mask],
                        obs.cpu().numpy().reshape(-1, OBS_DIM)[mask],
                        np.full(int(mask.sum()), done, np.float32))
            if replay.size >= cfg.batch_size:
                for _ in range(cfg.updates_per_epoch):
                    batch = tuple(torch.from_numpy(a).to(dev)
                                  for a in replay.sample(rng, cfg.batch_size))
                    params, opt_state, loss = update(params, target,
                                                     opt_state, batch)
                    losses.append(float(loss))
                    n_upd += 1
                    if n_upd % cfg.target_sync == 0:
                        target = params
        history.append({"episode": ep, "epsilon": eps, "return": ep_ret,
                        "loss": float(np.mean(losses)) if losses
                        else float("nan")})
        if log_fn and (ep % log_every == 0 or ep == episodes - 1):
            log_fn(f"[dqn] ep {ep:3d} eps {eps:.2f} "
                   f"return {ep_ret:12.1f} loss {history[-1]['loss']:.4f}")
    return params, history


# --------------------------------------------------------------------------- #
# export / evaluation
# --------------------------------------------------------------------------- #
def greedy_schedule(gym: BatchSimGym, params, *,
                    cell: Optional[int] = None) -> Dict[str, float]:
    """Roll the greedy policy once and export the *modal* action per
    function as its static warm dwell.  ``cell=None`` pools every cell a
    function name appears in (names repeat across same-generator seeds);
    an int restricts to that cell."""
    actions = np.asarray(gym.actions, np.float32)
    votes: Dict[str, np.ndarray] = {}
    state, obs = gym.reset()
    for _ in range(gym.num_epochs):
        act = _greedy(params, obs)
        for ci, names in enumerate(gym.function_names):
            if cell is not None and ci != cell:
                continue
            for fi, name in enumerate(names):
                votes.setdefault(
                    name, np.zeros(len(actions)))[act[ci, fi]] += 1
        state, obs, _, _ = gym.step(state, actions[act])
    return {name: float(actions[int(np.argmax(v))])
            for name, v in sorted(votes.items())}


def mean_q_schedule(gym: BatchSimGym, params) -> Dict[str, float]:
    """Static distillation by expected value: per function, accumulate
    the Q-vector at every state a greedy rollout visits and export the
    action with the highest *mean* Q."""
    actions = np.asarray(gym.actions, np.float32)
    qsum: Dict[str, np.ndarray] = {}
    state, obs = gym.reset()
    for _ in range(gym.num_epochs):
        with torch.no_grad():
            q = apply_qnet(params, obs).cpu().numpy()
        act = np.argmax(q, axis=-1)
        for ci, names in enumerate(gym.function_names):
            for fi, name in enumerate(names):
                acc = qsum.setdefault(name,
                                      np.zeros(len(actions), np.float64))
                acc += q[ci, fi]
        state, obs, _, _ = gym.step(state, actions[act])
    return {name: float(actions[int(np.argmax(q))])
            for name, q in sorted(qsum.items())}


def export_schedule(gym: BatchSimGym, params, *, log_fn=None) \
        -> Tuple[Dict[str, float], Dict[str, float], str]:
    """Distill the Q-policy both ways, score each on the gym, and return
    ``(warm_s, eval_metrics, method)`` for the better one."""
    candidates = {"modal_vote": greedy_schedule(gym, params),
                  "mean_q": mean_q_schedule(gym, params)}
    scored = {m: evaluate_schedule(gym, w) for m, w in candidates.items()}
    best = max(scored, key=lambda m: scored[m]["reward"])
    if log_fn:
        for m in candidates:
            log_fn(f"[export] {m:10s} reward {scored[m]['reward']:10.1f}"
                   f"{'  <- exported' if m == best else ''}")
    return candidates[best], scored[best], best


def save_schedule(path: str, warm_s: Dict[str, float], *,
                  default_s: Optional[float] = None,
                  meta: Optional[dict] = None) -> None:
    """Write the exported schedule in the ``load_keepalive_schedule``
    format (``repro_torch.core.policies.lifetime``)."""
    if default_s is None and warm_s:
        vals = sorted(warm_s.values())
        default_s = vals[len(vals) // 2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"version": SCHEDULE_VERSION, "warm_s": warm_s,
                   "default_s": default_s, "meta": meta or {}}, fh,
                  indent=1, sort_keys=True)


def evaluate_schedule(gym: BatchSimGym, warm_s: Dict[str, float], *,
                      default_s: float = 120.0) -> Dict[str, float]:
    """Episode return of an exported schedule on the gym's reward."""
    return gym.evaluate(gym.warm_grid(warm_s, default_s))
