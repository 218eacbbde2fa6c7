"""The port's dry run and roofline (``launch/dryrun.py``, ``launch/roofline.py``)
against the JAX package's, on the CPU.

* The spec pass over every (architecture, shape, production mesh): 66
  records ``ok``, 14 ``skipped`` with the reference's reason, 0 errors.
* The meta pass: loss + backward, prefill and decode of a reduced config of
  every family on meta tensors, their outputs' shapes and dtypes equal to
  the reference's ``jax.eval_shape`` (leaf by leaf, the reference's stacked
  lead axis dropped), with no kernel launch counted; each kernel wrapper's
  meta outputs shaped as its plain version's.
* The reference's analytic terms (``analytic_loop_costs``, ``model_flops``)
  equal for every pair; the FLOP counter's total against a hand count of a
  reduced dense config's matmuls (within 1%); the kernels' work formulas
  against the bytes of the plain versions' inputs and outputs.
"""
import json
import math

import jax
import pytest
import torch

from repro.config import (ARCH_IDS, SHAPES, get_config as jget, get_shape as jshape,
                          reduced as jreduced, supports_shape as jsupports)
from repro.launch import dryrun as jdryrun
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch.config import InputShape, get_config, get_shape, reduced
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ks
from repro_torch.kernels.ref import attention_mask
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe, registry
from repro_torch.training.train_loop import value_and_grad
from test_torch_sharding import _flat, _port_names, _stacked

FAMILIES = {"dense": "granite3_2b", "moe": "qwen3_moe_30b_a3b", "hybrid": "jamba_v01_52b",
            "xlstm": "xlstm_125m", "whisper": "whisper_large_v3", "vision": "internvl2_1b"}


def _counts():
    return kf.launches, kf.bwd_launches, kd.launches, ks.launches, ks.bwd_launches


# --------------------------------------------------------------------------- #
# the spec pass
# --------------------------------------------------------------------------- #


def test_spec_pass_over_every_pair_and_both_meshes(capsys):
    dryrun.main(["--all", "--both-meshes", "--no-compile"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("# dry-run: 66 ok, 14 skipped, 0 errors / 80 pairs")
    recs = [json.loads(line) for line in lines[:-1]]
    assert len(recs) == 80
    for rec in recs:
        cfg, shape = jget(rec["arch"]), jshape(rec["shape"])
        if jsupports(cfg, shape):
            assert rec["status"] == "ok", rec
            mem = rec["bytes_per_device"]
            assert mem["argument"] > 0 and mem["output"] is mem["temp"] is mem["peak"] is None
            assert rec["num_params"] == cfg.param_count()
        else:
            assert rec["status"] == "skipped"
            assert rec["reason"].startswith("full-attention arch: long_500k requires")


def test_argument_bytes_on_one_chip_are_every_argument_whole():
    """On a (1, 1) mesh nothing splits: params + fp32 m and v + the int32
    step + the int32 batch for train; params + caches + token + pos for
    decode."""
    cfg = reduced(get_config("jamba-v0.1-52b"))
    one = roofline.one_chip()
    train = InputShape("t", 64, 2, "train")
    state = registry.build(cfg, train, device="meta").params_spec()
    p_bytes = sum(x.numel() * x.element_size() for x in state.values())
    n = sum(x.numel() for x in state.values())
    rec = dryrun.dry_run(cfg, train, one, meta=False)
    assert rec["bytes_per_device"]["argument"] == p_bytes + 8 * n + 4 + 2 * 2 * 64 * 4
    decode = InputShape("d", 64, 2, "decode")
    caches = registry.input_specs(cfg, decode)["caches"]
    c_bytes = sum(x.numel() * x.element_size() for _, x in _flat(caches))
    rec = dryrun.dry_run(cfg, decode, one, meta=False)
    assert rec["bytes_per_device"]["argument"] == p_bytes + c_bytes + 2 * 4 + 4


def test_meta_pass_counts_the_ep_combine_per_device():
    """Under a (1, 4) mesh a reduced MoE takes the EP path on the meta pass:
    one fp32 (B, S, d) combine a MoE layer, over tokens split by no axis."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    shape = InputShape("p", 1024, 2, "prefill")
    rec = dryrun.dry_run(cfg, shape, MeshShape((1, 4), ("data", "model")))
    n_moe = sum(cfg.moe_layer_mask())
    assert rec["collectives"] == {"all-reduce": float(n_moe * 2 * 1024 * cfg.d_model * 4)}
    rec = dryrun.dry_run(cfg, shape, MeshShape((2, 2), ("data", "model")))
    assert rec["collectives"] == {"all-reduce": float(n_moe * 1024 * cfg.d_model * 4)}
    assert moe.allreduce_bytes["backward"] == 0


# --------------------------------------------------------------------------- #
# the meta pass against the reference's eval_shape
# --------------------------------------------------------------------------- #


def _ref_leaves(tree):
    return [(jspecs._pathstr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same(tensor, struct, what):
    assert tuple(tensor.shape) == tuple(struct.shape), what
    assert tensor.dtype == getattr(torch, str(struct.dtype)), what
    assert tensor.device.type == "meta", what


def _held_caches(caches, jcaches, jcfg):
    port = dict(_flat(caches))
    period = jtransformer.period_len(jcfg)
    n = 0
    for path, leaf in _ref_leaves(jcaches):
        head, _, last = path.rpartition("/")
        for i in range(leaf.shape[0]):
            name = (f"{head}.{i}.{last}" if jcfg.encoder is not None
                    else f"{i * period + int(head)}.{last}")
            _same(port[name], jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype), name)
            n += 1
    assert n == len(port)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_pass_matches_the_reference_eval_shape(family, kind):
    arch = FAMILIES[family]
    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    shape = InputShape(f"{kind}_smoke", 64, 2, kind)
    jb, b = jregistry.build(jcfg, shape), registry.build(cfg, shape, device="meta")
    jp, jin = jb.params_spec(), jregistry.input_specs(jcfg, shape)
    params, inputs = b.empty(), registry.input_specs(cfg, shape)
    want_keys = {f"batch.{n}" for n in jin.get("batch", {})} | {k for k in ("token", "pos")
                                                                  if k in jin}
    assert {k for k, _ in _flat(inputs) if not k.startswith("caches.")} == want_keys
    for key in jin.get("batch", {}):
        _same(inputs["batch"][key], jin["batch"][key], key)
    for key in ("token", "pos"):
        if key in jin:
            _same(inputs[key], jin[key], key)
    before = _counts()
    if kind == "train":
        want_loss, want_grads = jax.eval_shape(
            jax.value_and_grad(lambda p, x: jb.loss(p, x)[0]), jp, jin["batch"])
        loss, _, grads = value_and_grad(b, params, inputs["batch"])
        _same(loss, want_loss, "loss")
        period = jtransformer.period_len(jcfg) if jcfg.encoder is None else 1
        n = 0
        for path, leaf in _ref_leaves(want_grads):
            lead = leaf.shape[0] if _stacked(path) else 1
            struct = jax.ShapeDtypeStruct(leaf.shape[1:] if _stacked(path) else leaf.shape,
                                          leaf.dtype)
            for name in _port_names(path, lead, period):
                _same(grads[name], struct, name)
                n += 1
        assert n == len(grads)
    elif kind == "prefill":
        want_logits, want_caches, _ = jax.eval_shape(jb.prefill, jp, jin["batch"])
        with torch.no_grad():
            logits, caches, pos = b.prefill(params, inputs["batch"])
        _same(logits, want_logits, "logits")
        _held_caches(caches, want_caches, jcfg)
        assert pos == 64
    else:
        want_logits, want_caches = jax.eval_shape(jb.decode_step, jp, jin["caches"],
                                                  jin["token"], jin["pos"])
        with torch.no_grad():
            logits, caches = b.decode_step(params, inputs["caches"], inputs["token"],
                                           inputs["pos"])
        _same(logits, want_logits, "logits")
        _held_caches(caches, want_caches, jcfg)
    assert _counts() == before


def _kernel_calls(device):
    """Each kernel wrapper and both autograd Functions on small tensors."""
    g = torch.Generator().manual_seed(3)

    def t(*shape):
        return torch.randn(shape, generator=g).to(device)

    q, k, v = t(1, 24, 4, 16), t(1, 24, 2, 16), t(1, 24, 2, 16)
    pos = torch.arange(24, dtype=torch.int32).to(device)
    o, m, linv = kf.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos, stats=True)
    u, B, C = t(2, 40, 8), t(2, 40, 4), t(2, 40, 4)
    delta, A, D, h0 = t(2, 40, 8).abs() * 0.1, -t(8, 4).abs(), t(8), t(2, 8, 4)
    y, hT, ckpt = ks.ssm_scan_hopper(u, delta, A, B, C, D, h0, checkpoints=True)
    out = {"flash": (kf.flash_attention_hopper(q, k, v, q_pos=pos, kv_pos=pos),),
           "flash_stats": (o, m, linv),
           "flash_bwd": kf.flash_attention_bwd_hopper(q, k, v, o, o, m, linv, q_pos=pos,
                                                      kv_pos=pos),
           "decode": (kd.decode_attention_hopper(q[:, 0].contiguous(), k, v,
                                                 torch.ones((1, 24), dtype=torch.bool)
                                                 .to(device)),),
           "ssm": (y, hT, ckpt), "ssm_serve": ks.ssm_scan_hopper(u, delta, A, B, C, D, h0),
           "ssm_bwd": ks.ssm_scan_bwd_hopper(u, delta, A, B, C, D, h0, ckpt, y, hT)}
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v, u)]
    ops.flash_attention(*leaves[:3]).sum().backward()
    ops.ssm_scan(leaves[3], delta, A, B, C, D, h0)[0].sum().backward()
    out["autograd"] = tuple(x.grad for x in leaves)
    return out


def test_kernel_wrappers_on_meta_give_the_plain_shapes_and_launch_nothing():
    before = _counts()
    meta, plain = _kernel_calls("meta"), _kernel_calls("cpu")
    assert _counts() == before
    for name, got in meta.items():
        assert [(x.shape, x.dtype, x.device.type) for x in got] == \
            [(x.shape, x.dtype, "meta") for x in plain[name]], name


# --------------------------------------------------------------------------- #
# the roofline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_loop_costs_and_model_flops_equal_the_reference(arch, shape_name):
    jcfg, cfg = jget(arch), get_config(arch)
    assert roofline.analytic_loop_costs(cfg, get_shape(shape_name)) == \
        jroofline.analytic_loop_costs(jcfg, jshape(shape_name))
    assert roofline.model_flops(cfg, get_shape(shape_name)) == \
        jroofline.model_flops(jcfg, jshape(shape_name))


def test_flop_counter_matches_a_hand_count_of_the_matmuls():
    """Reduced granite's prefill: every projection and MLP matmul of its
    layers and the last token's unembedding (attention itself runs in the
    flash kernel and is counted analytically)."""
    cfg = reduced(get_config("granite-3-2b"))
    b, s = 2, 64
    t = b * s
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    per_layer = 2 * t * (d * q + 2 * d * kv + q * d + 3 * d * ff)
    want = cfg.num_layers * per_layer + 2 * b * d * cfg.vocab_size
    got = roofline.count_meta_pass(cfg, InputShape("p", s, b, "prefill"))
    assert abs(got["flops"] - want) <= 0.01 * want
    assert sum(got["flops_by_dtype"].values()) == got["flops"]


@pytest.mark.parametrize("sq,skv,causal,window", [
    (16, 16, True, None), (7, 40, True, None), (64, 64, True, 8), (12, 30, False, None),
    (1, 33, True, 5), (40, 40, False, 6)])
def test_attention_pairs_match_the_mask(sq, skv, causal, window):
    q_pos = torch.arange(sq) + (skv - sq)
    want = attention_mask(q_pos, torch.arange(skv), causal=causal, window=window).sum().item()
    assert roofline.attention_pairs(sq, skv, causal=causal, window=window) == want


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_work_counts_each_input_and_output_once(dtype):
    """The work formulas' bytes against the tensors the plain versions read
    and write (the kernels' own signatures)."""
    g = torch.Generator().manual_seed(4)
    b, sq, skv, hq, hkv, d = 2, 24, 40, 4, 2, 16
    q, dout = (torch.randn((b, sq, hq, d), generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, skv, hkv, d), generator=g).to(dtype) for _ in range(2))
    qp, kp = torch.arange(sq, dtype=torch.int32) + skv - sq, torch.arange(skv, dtype=torch.int32)
    pairs = roofline.attention_pairs(sq, skv, causal=True, window=None)
    it = q.element_size()
    out = kf.flash_attention_hopper(q, k, v, q_pos=qp, kv_pos=kp)
    assert roofline.flash_work(b, sq, skv, hq, hkv, d, it, pairs).bytes == \
        _nbytes(q, k, v, out, qp, kp)
    o, m, linv = kf.flash_attention_hopper(q, k, v, q_pos=qp, kv_pos=kp, stats=True)
    w = roofline.flash_work(b, sq, skv, hq, hkv, d, it, pairs, stats=True)
    assert (w.bytes, w.flops, w.exps) == (_nbytes(q, k, v, o, m, linv, qp, kp),
                                          4.0 * b * hq * pairs * d, b * hq * pairs)
    grads = kf.flash_attention_bwd_hopper(q, k, v, o, dout, m, linv, q_pos=qp, kv_pos=kp)
    assert roofline.flash_bwd_work(b, sq, skv, hq, hkv, d, it, pairs).bytes == \
        _nbytes(q, k, v, o, dout, m, linv, *grads, qp, kp)
    mask = torch.arange(skv)[None].expand(b, skv) < torch.tensor([[30], [40]])
    mask = mask.contiguous()
    n_valid = mask.sum().item()
    got = kd.decode_attention_hopper(q[:, 0].contiguous(), k, v, mask)
    assert roofline.decode_work(b, skv, hq, hkv, d, it, n_valid).bytes == \
        _nbytes(q[:, 0], got, mask) + 2 * n_valid * hkv * d * it
    out, m, l = kd.decode_attention_hopper(q[:, 0].contiguous(), k, v, mask, stats=True)
    w = roofline.decode_work(b, skv, hq, hkv, d, it, n_valid, stats=True)
    assert (w.bytes, w.flops, w.exps) == (
        _nbytes(q[:, 0], out, m, l, mask) + 2 * n_valid * hkv * d * it,
        4.0 * n_valid * hq * d, n_valid * hq)
    bt, t, din, n = 2, 70, 8, 4
    u, B, C = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((bt, t, din), (bt, t, n), (bt, t, n)))
    delta = torch.rand((bt, t, din), generator=g) * 0.1
    A, D, h0 = -torch.rand((din, n), generator=g), torch.randn(din), torch.randn(bt, din, n)
    y, hT, ckpt = ks.ssm_scan_hopper(u, delta, A, B, C, D, h0, checkpoints=True)
    assert roofline.ssm_scan_work(bt, t, din, n, it).bytes == \
        _nbytes(u, delta, A, B, C, D, h0, y, hT)
    assert roofline.ssm_scan_work(bt, t, din, n, it, checkpoints=True).bytes == \
        _nbytes(u, delta, A, B, C, D, h0, y, hT, ckpt)
    grads = ks.ssm_scan_bwd_hopper(u, delta, A, B, C, D, h0, ckpt, y, hT)
    assert roofline.ssm_scan_bwd_work(bt, t, din, n, it).bytes == \
        _nbytes(u, delta, A, B, C, D, ckpt, y, hT, *grads)


def test_roofline_of_every_reduced_pair_runs(tmp_path, capsys):
    roofline.main(["--smoke", "--out", str(tmp_path / "r.json")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "# roofline: 40 ok / 40"
    for rec in map(json.loads, lines[:-1]):
        assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
        assert rec["bound_s"] > 0 and rec["collective_s"] == 0.0
        assert rec["flops_per_device"] >= rec["flop_counter_flops"]
        assert (rec["update_bytes_per_device"] > 0) == rec["shape"].startswith("train")
        assert rec["update_bytes_per_device"] < rec["bytes_per_device"]


def test_roofline_divides_by_the_chips_and_adds_the_ep_combine():
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    shape = InputShape("p", 1024, 2, "prefill")
    one = roofline.analyze(cfg, shape)
    four = roofline.analyze(cfg, shape, MeshShape((1, 4), ("data", "model")))
    assert math.isclose(four["flops_per_device"] * 4, one["flops_per_device"])
    assert math.isclose(four["memory_s"] * 4, one["memory_s"])
    combine = sum(cfg.moe_layer_mask()) * 2 * 1024 * cfg.d_model * 4
    assert four["collective_bytes_per_device"] == combine
    assert four["collective_s"] == combine / roofline.LINK_BW


def test_skipped_pairs_match_the_reference():
    """A pair the reference skips (it lowers nothing for it) is skipped here
    with the same record."""
    want = jdryrun.run_pair("starcoder2_15b", "long_500k")
    assert dryrun.run_pair("starcoder2_15b", "long_500k") == want
    assert want["status"] == "skipped"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_hold_the_bytes_kvcache_counts(arch):
    """``serving/kvcache.py``: the caches as meta tensors hold exactly the
    bytes ``cache_bytes`` counts, at a plain and at a windowed shape."""
    from repro_torch.serving import kvcache

    cfg = get_config(arch)
    for shape in (None, get_shape("long_500k")):
        seq = 1024 if shape is None else shape.seq_len
        caches = kvcache.caches_spec(cfg, 2, seq, shape)
        assert all(x.device.type == "meta" for _, x in _flat(caches))
        assert sum(x.numel() * x.element_size() for _, x in _flat(caches)) == \
            kvcache.cache_bytes(cfg, 2, seq, shape)
