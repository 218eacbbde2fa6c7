"""The port's sharding rules and partition specs against the JAX package's.

``make_rules`` is arithmetic on a mesh's axis sizes, so both packages see a
shape-only mesh (``tests/test_sharding.py``'s ``_FakeMesh`` for the
reference, ``launch.mesh.MeshShape`` for the port).  Parameter specs are held
leaf by leaf at full width: the reference's spec of each leaf of
``jax.eval_shape(init)``, its stacked lead axis dropped, against the port's
spec of the ``state_dict`` name that ``models/convert.py::params_from_jax``
gives that leaf's slice; cache specs the same way at ``decode_32k``.
"""
import jax
import numpy as np
import pytest
import torch

from repro import sharding as jsharding
from repro.config import ARCH_IDS, SHAPES, get_config as jget, get_shape as jshape
from repro.launch import specs as jspecs
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import sharding
from repro_torch.config import get_config, get_shape
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshShape, chips, make_host_mesh, make_production_mesh
from repro_torch.models import registry

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    """A spec with each one-axis tuple written as its axis name, as JAX's
    ``PartitionSpec`` writes it (the two name the same sharding)."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax for ax in spec)


class _FakeMesh:
    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_rules_matches_the_reference(arch, shape_name, mesh):
    want = jsharding.make_rules(jget(arch), jshape(shape_name), _FakeMesh(*MESHES[mesh]))
    got = sharding.make_rules(get_config(arch), get_shape(shape_name), MeshShape(*MESHES[mesh]))
    assert got == want


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_respect_divisibility(arch, shape_name):
    """``tests/test_sharding.py``'s divisibility check, on the port's rules."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh()
    rules = sharding.make_rules(cfg, shape, mesh)

    def size(ax):
        return sharding._axsize(mesh, ax)

    if rules["heads"]:
        assert cfg.num_heads % size(rules["heads"]) == 0
    if rules["qkv"]:
        assert cfg.q_dim % size(rules["qkv"]) == 0
        assert rules["heads"] is not None   # qkv sharded only with heads
    if rules["expert"]:
        assert cfg.moe.num_experts % size(rules["expert"]) == 0
    if rules["vocab_param"]:
        assert cfg.vocab_size % size(rules["vocab_param"]) == 0
    if rules["batch"]:
        assert shape.global_batch % size(rules["batch"]) == 0
    if rules.get("cache_seq"):
        assert shape.seq_len % size(rules["cache_seq"]) == 0


def _port_names(path: str, n_lead: int, period: int):
    """The port's names of a reference leaf at tree ``path``: a stacked leaf
    one name a layer (``blocks/<pos>/...`` over its repeats, ``enc_blocks``
    and ``dec_blocks`` over their layers), any other its dotted path."""
    head, _, rest = path.partition("/")
    if head == "blocks":
        pos, _, leaf = rest.partition("/")
        return [f"blocks.{r * period + int(pos)}.{leaf.replace('/', '.')}"
                for r in range(n_lead)]
    if head in ("enc_blocks", "dec_blocks"):
        return [f"{head}.{i}.{rest.replace('/', '.')}" for i in range(n_lead)]
    return [path.replace("/", ".")]


def _stacked(path: str) -> bool:
    return path.startswith(("blocks", "enc_blocks", "dec_blocks"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspec_matches_the_reference_on_every_leaf(arch, mesh):
    jcfg, cfg = jget(arch), get_config(arch)
    shape = get_shape("train_4k")
    jrules = jsharding.make_rules(jcfg, jshape("train_4k"), _FakeMesh(*MESHES[mesh]))
    rules = sharding.make_rules(cfg, shape, MeshShape(*MESHES[mesh]))
    leaves = jax.tree_util.tree_flatten_with_path(jregistry.build(jcfg).params_spec())[0]
    state = registry.build(cfg, device="meta").params_spec()
    got = specs.params_shardings(state, rules, MeshShape(*MESHES[mesh]))
    period = jtransformer.period_len(jcfg) if jcfg.encoder is None else 1
    seen = 0
    for path, leaf in leaves:
        path = jspecs._pathstr(path)
        want = _norm(jspecs.param_pspec(path, leaf.ndim, jrules))
        lead = leaf.shape[0] if _stacked(path) else 1
        if _stacked(path):
            want = want[1:]
        for name in _port_names(path, lead, period):
            assert _norm(got[name]) == want, (path, name)
            assert tuple(state[name].shape) == tuple(leaf.shape[1:] if _stacked(path)
                                                      else leaf.shape), name
            seen += 1
    assert seen == len(state)


def _flat(tree, path=""):
    """(dotted path, leaf) of a tree of dicts and lists (a spec tuple is a
    leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}{i}.")
    else:
        yield path[:-1], tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspec_matches_the_reference_on_every_leaf(arch):
    """decode_32k on the single-pod mesh: each cache leaf's spec and shape,
    the reference's stacked lead axis dropped."""
    jcfg, cfg = jget(arch), get_config(arch)
    mesh = MeshShape(*MESHES["16x16"])
    jrules = jsharding.make_rules(jcfg, jshape("decode_32k"), _FakeMesh(*MESHES["16x16"]))
    rules = sharding.make_rules(cfg, get_shape("decode_32k"), mesh)
    jcaches = jregistry.input_specs(jcfg, jshape("decode_32k"))["caches"]
    caches = registry.input_specs(cfg, get_shape("decode_32k"))["caches"]
    got = dict(_flat(specs.caches_shardings(caches, rules, mesh)))
    port = dict(_flat(caches))
    period = jtransformer.period_len(jcfg)
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcaches)[0]:
        path = jspecs._pathstr(path)
        want = _norm(jspecs.cache_pspec(path, leaf.ndim, jrules))[1:]
        head, _, last = path.rpartition("/")
        if jcfg.encoder is not None:      # {"self"|"cross": {"k", "v"}} over all layers
            names = [f"{head}.{i}.{last}" for i in range(leaf.shape[0])]
        else:                             # [period position]{leaf} over the repeats
            names = [f"{r * period + int(head)}.{last}" for r in range(leaf.shape[0])]
        for name in names:
            assert _norm(got[name]) == want, (path, name)
            assert tuple(port[name].shape) == tuple(leaf.shape[1:]), name
            assert str(port[name].dtype) == f"torch.{leaf.dtype}", name
            seen += 1
    assert seen == len(port)


def test_local_shape_pads_an_uneven_split():
    mesh = make_production_mesh()
    cfg = get_config("granite-3-2b")
    rules = sharding.make_rules(cfg, get_shape("train_4k"), mesh)
    assert rules["vocab"] == "model" and rules["vocab_param"] is None
    assert specs.local_shape((49155, 2048), ("model", ("data",)), mesh) == (3073, 128)
    assert specs.local_shape((49155, 2048), (None, None), mesh) == (49155, 2048)
    pods = make_production_mesh(multi_pod=True)
    assert specs.local_shape((256, 4096), (("pod", "data"),), pods) == (8, 4096)
    assert chips(mesh) == 256 and chips(pods) == 512


def test_specs_name_only_axes_of_the_mesh():
    cfg = get_config("qwen3-moe-30b-a3b")
    rules = sharding.make_rules(cfg, get_shape("train_4k"), make_production_mesh())
    state = registry.build(cfg, device="meta").params_spec()
    with pytest.raises(ValueError, match="not in mesh"):
        specs.params_shardings(state, rules, MeshShape((4,), ("data",)))


def test_logical_is_a_no_op_where_nothing_splits_and_raises_where_it_would():
    x = torch.zeros(4, 8)
    cfg = get_config("granite-3-2b")
    shape = get_shape("train_4k")
    assert sharding.logical(x, ("batch", "embed")) is x
    assert sharding.spec_for(("batch", None)) == ()
    one = MeshShape((1, 1), ("data", "model"))
    with sharding.use_rules(sharding.make_rules(cfg, shape, one), one):
        assert sharding.current_rules_and_mesh()[1] is one
        assert sharding.logical(x, ("batch", "heads")) is x
        assert sharding.spec_for(("batch", "heads")) == (("data",), "model")
    mesh = make_production_mesh()
    with sharding.use_rules(sharding.make_rules(cfg, shape, mesh), mesh):
        with pytest.raises(NotImplementedError, match="ROADMAP item A8"):
            sharding.logical(x, ("batch", "heads"))
    assert sharding.current_rules_and_mesh() is None


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_host_mesh()


def test_opt_state_and_batch_specs():
    cfg = get_config("whisper-large-v3")
    mesh = make_production_mesh()
    rules = sharding.make_rules(cfg, get_shape("train_4k"), mesh)
    batch = registry.input_specs(cfg, get_shape("train_4k"))["batch"]
    got = specs.batch_shardings(batch, rules, mesh)
    assert got == {"tokens": (("data",), None), "labels": (("data",), None),
                   "frames": (("data",), None, None)}
    p_sh = {"embed": ("model", ("data",))}
    opt = specs.opt_state_shardings(None, p_sh, mesh)
    assert opt.step == () and opt.m is p_sh and opt.v is p_sh
    assert np.prod(specs.local_shape(tuple(batch["frames"].shape), got["frames"], mesh)) \
        == 256 // 16 * 1500 * 1280
