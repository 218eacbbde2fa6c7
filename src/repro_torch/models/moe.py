"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing and
sort-based capacity dispatch, on one device or expert-parallel.

Tokens are cut into groups of at most ``GROUP``; within a group a stable sort
by expert packs them into an ``(experts, capacity, d_model)`` buffer, the
experts run as batched products, and each token takes back its rows weighted
by its renormalised router probabilities.  Tokens past an expert's capacity
drop (Switch-style).  Arctic's dense residual branch runs beside the
experts.  Returns the load-balance auxiliary loss with the output.

The expert-parallel path (the reference's ``shard_map``) runs on
``torch.distributed``: under a rules context that maps ``expert`` to a mesh
axis, each rank of that axis's process group holds the whole (replicated)
router and computes the same routing, dispatches only its own experts, runs
its slice of Arctic's dense residual, and one all-reduce combines the
partial outputs.  ``x`` is this rank's tokens, replicated over the group.

On DTensor activations (the GSPMD path, ``sharding.py``) both paths run one
``local_map``: each rank routes its token groups (split over ``moe_group``
where the groups fall whole in a rank's rows, else every rank routes all of
them), dispatches only the experts it holds (``wi`` / ``wg`` / ``wo`` split
over ``expert``: the reference's ``buf`` / ``out`` constraints), and the
partial outputs and aux losses are ``Partial`` sums, reduced where the
block's constraint asks for them whole.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models import layers

GROUP = 4096  # max tokens per dispatch group

# bytes the expert-parallel path all-reduced: "combine" in the forward,
# "backward" the replicated inputs' gradients; chip_smoke.py and the dry run
# reset and read them (on meta tensors they are counted, not sent)
allreduce_bytes = {"combine": 0, "backward": 0}


class MoE(nn.Module):
    """``router`` (d, E) fp32; ``wi``, ``wg`` (E, d, ff) and ``wo`` (E, ff, d)
    stacked over experts; ``dense`` the residual MLP where the config has one."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        m, d, pdt = cfg.moe, cfg.d_model, cfg.param_dtype
        e, ff = m.num_experts, m.expert_ff

        def expert_stack(a, b):
            return layers._param(layers._trunc_normal(gen, (e, a, b), a ** -0.5,
                                                      layers.dt(pdt), device))

        self.router = layers.dense_init(gen, d, e, "float32", device=device)
        self.wi = expert_stack(d, ff)
        self.wo = expert_stack(ff, d)
        if cfg.act == "swiglu":
            self.wg = expert_stack(d, ff)
        if m.dense_residual:
            self.dense = layers.MLP(d, m.dense_residual_ff or cfg.d_ff, cfg.act, pdt,
                                    device=device, gen=gen)


def _capacity(tokens_per_group: int, m) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(m.top_k, min(c, tokens_per_group))


def _count(idx, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx``: ``jnp.bincount(idx,
    length=n)``, a fixed-length count (meta tensors run it; ``torch.bincount``
    has no meta kernel)."""
    return torch.zeros(n, dtype=idx.dtype, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _dispatch_group(x, p: MoE, cfg):
    """x: (t, d) one token group -> (y (t, d), aux_loss scalar)."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = _capacity(t, m)

    probs = torch.softmax(x.float() @ p.router, dim=-1)          # (t, E)
    # lax.top_k: the k largest, the lower expert first among equals
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _count(flat_e, e)                                   # (E,)
    offsets = torch.cumsum(counts, 0) - counts                   # exclusive
    pos_in_e = torch.arange(t * k, device=x.device) - offsets[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    tok_idx = order // k

    # row e*cap is the sink of every dropped assignment; it is cut off below
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok_idx]
    buf = buf[: e * cap].reshape(e, cap, d)

    h = torch.bmm(buf, p.wi)
    if hasattr(p, "wg"):
        h = F.silu(h) * torch.bmm(buf, p.wg)
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, p.wo)

    out_flat = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))], dim=0)
    y_sorted = out_flat[slot]                                    # (t*k, d)
    w_sorted = (top_w.reshape(t * k)[order] * keep).float()
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add_(
        0, tok_idx, y_sorted.float() * w_sorted[:, None])

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    f = counts.float() / (t * k)
    aux = e * torch.sum(f * probs.mean(dim=0))
    return y.to(x.dtype), aux


def _dispatch_group_local(x, p, cfg, *, rank, e_local):
    """Expert-parallel local dispatch: this rank owns experts
    [rank*e_local, (rank+1)*e_local).  Routing is computed over ALL experts
    (the router is replicated, and so is x over the group, so every rank
    computes identical routing); only locally-owned assignments are
    dispatched; the cross-rank combine is the caller's all-reduce.  ``p``
    holds the router and this rank's views of ``wi`` / ``wg`` / ``wo``.
    """
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = _capacity(t, m)

    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(t * k)
    flat_w = top_w.reshape(t * k)
    owned = (flat_e >= rank * e_local) & (flat_e < (rank + 1) * e_local)
    local_e = torch.where(owned, flat_e - rank * e_local, e_local)   # sentinel
    order = torch.argsort(local_e, stable=True)
    sorted_e = local_e[order]
    counts = _count(local_e, e_local + 1)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=x.device) - offsets[sorted_e]
    keep = (pos_in_e < cap) & (sorted_e < e_local)
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e_local * cap)
    tok_idx = order // k

    buf = torch.zeros((e_local * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok_idx]
    buf = buf[: e_local * cap].reshape(e_local, cap, d)
    h = torch.bmm(buf, p["wi"])
    if "wg" in p:
        h = F.silu(h) * torch.bmm(buf, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, p["wo"])
    out_flat = torch.cat([out.reshape(e_local * cap, d), out.new_zeros((1, d))], dim=0)
    y_sorted = out_flat[slot]
    w_sorted = (flat_w[order] * keep).float()
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add_(
        0, tok_idx, y_sorted.float() * w_sorted[:, None])

    # aux loss: identical on every rank (global routing stats)
    f = _count(flat_e, e).float() / (t * k)
    aux = e * torch.sum(f * probs.mean(dim=0))
    return y.to(x.dtype), aux


def _all_reduce(t: torch.Tensor, group, what: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (counted in ``allreduce_bytes``; a
    meta tensor, or no group, is counted and not sent)."""
    allreduce_bytes[what] += t.numel() * t.element_size()
    if group is not None and t.device.type != "meta":
        import torch.distributed as dist

        dist.all_reduce(t, group=group)
    return t


class _Combine(torch.autograd.Function):
    """The combine: an all-reduce (sum) over the group forward, the identity
    backward.  Every rank receives the same upstream gradient and takes its
    own experts' share of it (an all-reducing backward would count each
    expert's gradient once per rank)."""

    @staticmethod
    def forward(ctx, y, group):
        return _all_reduce(y.clone(), group, "combine")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Replicated(torch.autograd.Function):
    """A replicated input (x, the router): the identity forward, an all-reduce
    (sum) of the gradient backward, which adds up every rank's partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group, "backward"), None


def _model_group(mesh, axis: str, msize: int, x):
    """(this rank's index along ``axis``, its process group).  A DeviceMesh
    gives both; its backend must be the tensors' (NCCL for CUDA, gloo for
    CPU).  A mesh of shapes only (the dry run) runs meta tensors as rank 0,
    or real ones where the axis has one rank."""
    if hasattr(mesh, "get_group"):
        import torch.distributed as dist

        group = mesh.get_group(axis)
        want = {"cuda": "nccl", "cpu": "gloo"}.get(x.device.type)
        if x.device.type != "meta" and dist.get_backend(group) != want:
            raise ValueError(f"expert-parallel MoE on {x.device.type} tensors takes a "
                             f"{want} process group, not {dist.get_backend(group)}")
        return mesh.get_local_rank(axis), group
    if x.device.type != "meta" and msize > 1:
        raise ValueError(f"expert-parallel MoE over {msize} ranks needs a DeviceMesh "
                         f"(launch.mesh.make_host_mesh), not {mesh!r}")
    return 0, None


def _axes(ax) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def _moe_ffn_sharded(p: MoE, x, cfg, rules, mesh, *, ep: bool):
    """The MoE on DTensor ``x`` (B, S, d) through ``local_map``.  The groups
    are those of the path: of each data shard's tokens under ``ep`` (the
    reference's ``shard_map``), else of all tokens (its GSPMD ``vmap``), split
    over ``moe_group`` where each rank's rows hold whole groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    m = cfg.moe
    b, s, d = x.shape
    names = list(mesh.mesh_dim_names)
    grp, exp = _axes(rules.get("moe_group")), _axes(rules.get("expert"))
    g_ranks = math.prod(mesh.size(names.index(a)) for a in grp)
    e_ranks = math.prod(mesh.size(names.index(a)) for a in exp)
    t_local = b * s // g_ranks
    gs = min(GROUP, t_local if ep else b * s)
    split = bool(grp) and (ep or t_local % gs == 0)
    if not split:
        g_ranks = 1
    e_local = m.num_experts // e_ranks
    e_rank = 0
    for a in exp:
        e_rank = e_rank * mesh.size(names.index(a)) + mesh.get_local_rank(a)

    rep, part = Replicate(), Partial()
    xp, xg, wp, wg, yp = [], [], [], [], []    # x, its grad; experts, theirs; y / aux
    for a in names:
        if split and a in grp:
            xp.append(Shard(0)), xg.append(Shard(0)), wp.append(rep), wg.append(part)
            yp.append(part)
        elif a in exp:
            xp.append(rep), xg.append(part), wp.append(Shard(0)), wg.append(Shard(0))
            yp.append(part)
        else:
            xp.append(rep), xg.append(rep), wp.append(rep), wg.append(rep), yp.append(rep)
    # the router is whole on every rank, and its gradient partial wherever
    # the tokens or the experts are split
    rg = [part if isinstance(g, Partial) or isinstance(w, Shard) else rep
          for g, w in zip(wg, wp)]
    yp_tok = [Shard(0) if (split and a in grp) else y for a, y in zip(names, yp)]
    leaves = [p.router, p.wi, p.wo] + ([p.wg] if hasattr(p, "wg") else [])

    def local(x, router, wi, wo, wg=None):
        parts = {"router": router, "wi": wi, "wo": wo}
        if wg is not None:
            parts["wg"] = wg
        flat = x.reshape(-1, d)
        t = flat.shape[0]
        g = t // gs
        groups = flat.reshape(g, gs, d) if g * gs == t else flat.reshape(1, t, d)
        ys, auxs = zip(*(_dispatch_group_local(xx, parts, cfg, rank=e_rank, e_local=e_local)
                         for xx in groups))
        # every expert rank's aux is the whole one, every group rank's the
        # mean of its groups: the Partial sums over both take their shares
        aux = torch.stack(auxs).mean() / (g_ranks * e_ranks)
        return torch.stack(ys).reshape(x.shape), aux

    fn = local_map(local, out_placements=(yp_tok, yp), device_mesh=mesh,
                   redistribute_inputs=True,
                   in_placements=(xp, [rep] * len(names)) + (wp,) * (len(leaves) - 1),
                   in_grad_placements=(xg, rg) + (wg,) * (len(leaves) - 1))
    y, aux = fn(x, *leaves)
    if hasattr(p, "dense"):
        y = y + layers.mlp_apply(p.dense, x, cfg.act)
    return y, m.router_aux_weight * aux


def _moe_ffn_ep(p: MoE, x, cfg, rules, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert-parallel MoE: the sort-based dispatch stays local, and
    the only collective is the combine's all-reduce of the token outputs.
    DTensor ``x`` takes :func:`_moe_ffn_sharded`."""
    if sharding.is_dtensor(x):
        return _moe_ffn_sharded(p, x, cfg, rules, mesh, ep=True)
    model_ax = rules["expert"]
    msize = sharding._axsize(mesh, model_ax)
    m = cfg.moe
    e_local = m.num_experts // msize
    rank, group = _model_group(mesh, model_ax, msize, x)
    x = _Replicated.apply(x, group)
    lo, hi = rank * e_local, (rank + 1) * e_local
    parts = {"router": _Replicated.apply(p.router, group),
             "wi": p.wi[lo:hi], "wo": p.wo[lo:hi]}
    if hasattr(p, "wg"):
        parts["wg"] = p.wg[lo:hi]

    b, s, d = x.shape
    t = b * s
    gs = min(GROUP, t)
    g = t // gs if t % gs == 0 else 1
    gs = t // g
    ys, auxs = zip(*(_dispatch_group_local(xx, parts, cfg, rank=rank, e_local=e_local)
                     for xx in x.reshape(g, gs, d)))
    y = torch.stack(ys).reshape(b, s, d).float()
    if hasattr(p, "dense"):
        # the dense residual on this rank's slice of its ff dim (where the
        # rules shard ff over the same axis; else rank 0 runs it whole): its
        # partial sums ride the same combine
        dense = p.dense
        ff = dense.wi.shape[1]
        if rules.get("ff") == model_ax:
            cols = slice(rank * ff // msize, (rank + 1) * ff // msize)
        else:
            cols = slice(0, ff if rank == 0 else 0)
        h = x @ dense.wi[:, cols]
        if hasattr(dense, "wg"):
            h = F.silu(h) * (x @ dense.wg[:, cols])
        else:
            h = F.gelu(h, approximate="tanh")
        y = y + (h @ dense.wo[cols]).float()
    y = _Combine.apply(y, group)
    # every rank computes the whole aux loss, and the replicated inputs'
    # backward sums its gradient over the group: each rank passes on 1/msize
    aux = torch.stack(auxs).mean()
    aux = aux.detach() + (aux - aux.detach()) / msize
    return y.to(x.dtype), m.router_aux_weight * aux


def moe_ffn(p: MoE, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar).

    Takes the expert-parallel path whenever an active rules context maps
    experts to a mesh axis and the call has at least 2048 tokens (the
    reference's threshold: below it the replicated local dispatch costs more
    than it saves); otherwise the single-device path."""
    ctx = sharding.current_rules_and_mesh()
    if ctx is not None:
        rules, mesh = ctx
        if rules.get("expert") and x.shape[0] * x.shape[1] >= 2048:
            return _moe_ffn_ep(p, x, cfg, rules, mesh)
        if sharding.is_dtensor(x):
            return _moe_ffn_sharded(p, x, cfg, rules, mesh, ep=False)
    b, s, d = x.shape
    t = b * s
    gs = min(GROUP, t)
    g = t // gs
    xg = x.reshape(g, gs, d) if g * gs == t else x.reshape(1, t, d)
    xg = sharding.logical(xg, ("moe_group", None, None))
    ys, auxs = zip(*(_dispatch_group(xx, p, cfg) for xx in xg))
    out = torch.stack(ys).reshape(b, s, d)
    if hasattr(p, "dense"):
        out = out + layers.mlp_apply(p.dense, x, cfg.act)
    return out, cfg.moe.router_aux_weight * torch.stack(auxs).mean()
