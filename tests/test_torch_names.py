"""Every public name and keyword of the JAX package is in the port.

The reference is read as source (``ast``), never imported, so this file needs
neither JAX nor ``repro``.  For each module under ``src/repro/`` the port's
module at the same relative path must define (or import) each top-level
public name of the reference's, and each public function and method must
take every parameter the reference's takes, unless the port takes
``**kwargs`` or the difference is one of the stated deviations below.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

PALLAS = "a Pallas entry point and its block constants: the port's kernels are CUDA"
FUNCTIONAL_INIT = "the functional init is replaced by the module class's constructor"
RNG = "a torch.Generator `gen` takes the place of a JAX key `rng`"
# (module, name): why the port does not define it
MISSING = {
    ("kernels/cluster_step.py", "cluster_sim_pallas"): PALLAS,
    ("kernels/cluster_step.py", "DEFAULT_CHUNK"): PALLAS,
    ("kernels/decode_attention.py", "decode_attention_pallas"): PALLAS,
    ("kernels/decode_attention.py", "DEFAULT_BLOCK_S"): PALLAS,
    ("kernels/flash_attention.py", "flash_attention_pallas"): PALLAS,
    ("kernels/flash_attention.py", "DEFAULT_BLOCK_Q"): PALLAS,
    ("kernels/flash_attention.py", "DEFAULT_BLOCK_K"): PALLAS,
    ("kernels/ssm_scan.py", "ssm_scan_pallas"): PALLAS,
    ("kernels/ssm_scan.py", "DEFAULT_CHUNK"): PALLAS,
    ("kernels/ssm_scan.py", "DEFAULT_BLOCK_D"): PALLAS,
    ("kernels/ops.py", "NEG_INF"): "the kernel modules keep the -1e30 sentinel in their "
                                   "own plain versions (kernels/ref.py)",
    ("launch/dryrun.py", "collective_bytes"): "it parses compiled HLO text; the port "
                                              "counts the EP all-reduce bytes instead",
    ("sharding.py", "named_sharding"): "a jax NamedSharding; the port places DTensors "
                                       "(sharding.placements)",
    ("models/attention.py", "init_attention"): FUNCTIONAL_INIT,
    ("models/layers.py", "mlp_init"): FUNCTIONAL_INIT,
    ("models/mamba.py", "init_mamba"): FUNCTIONAL_INIT,
    ("models/moe.py", "init_moe"): FUNCTIONAL_INIT,
    ("models/xlstm.py", "init_mlstm"): FUNCTIONAL_INIT,
    ("models/xlstm.py", "init_slstm"): FUNCTIONAL_INIT,
}
# (module, function, parameter): why the port's function does not take it
NARROWED = {
    ("core/batchsim.py", "run_tables", "interpret"): "Pallas interpret mode; the CPU runs "
                                                     "the plain version",
    ("core/batchsim.py", "simulate_batch", "interpret"): "Pallas interpret mode",
    ("launch/specs.py", "param_pspec", "path"): "a state_dict name takes the place of a "
                                                "pytree path",
    ("models/transformer.py", "stack_full", "stack_params"): "the stacked tree is the "
                                                             "module's `blocks`",
    ("models/transformer.py", "stack_decode", "stack_params"): "the stacked tree is the "
                                                               "module's `blocks`",
    **{(m, f, "rng"): RNG for m, f in [
        ("learn/agent.py", "init_qnet"), ("learn/forecaster.py", "init_forecaster"),
        ("models/encdec.py", "init_encdec"), ("models/layers.py", "dense_init"),
        ("models/layers.py", "embed_init"), ("models/layers.py", "posembed_init"),
        ("models/lm.py", "init_lm"), ("models/transformer.py", "init_stack")]},
}


def _params(node):
    """(parameter names, takes **kwargs) of a function definition."""
    a = node.args
    return ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs], a.kwarg is not None)


def public_api(path: Path):
    """Top-level names of a module: {name: (kind, params, methods)}; kind is
    def, class, var or import; a class's methods are its public ones and
    ``__init__``."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _params(node), {})
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", None, {
                b.name: _params(b) for b in node.body
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (not b.name.startswith("_") or b.name == "__init__")})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in [t] if isinstance(t, ast.Name) else getattr(t, "elts", []):
                    if isinstance(n, ast.Name):
                        out[n.id] = ("var", None, {})
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], ("import", None, {}))
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _narrowed(module, where, ref_params, port_params):
    names, kwargs = port_params
    return [] if kwargs else [p for p in ref_params[0] if p not in names
                              and (module, where, p) not in NARROWED]


@pytest.mark.parametrize("module", MODULES)
def test_port_module_has_the_reference_names_and_keywords(module):
    assert (PORT / module).exists(), f"no port of {module}"
    ref, port = public_api(REF / module), public_api(PORT / module)
    faults = []
    for name, (kind, params, methods) in ref.items():
        if kind == "import" or (module, name) in MISSING:
            continue
        if name not in port:
            faults.append(f"{kind} {name} missing")
            continue
        pkind, pparams, pmethods = port[name]
        if kind == "def" and pkind == "def":
            faults += [f"{name}({p}=...) missing"
                       for p in _narrowed(module, name, params, pparams)]
        for meth, mparams in methods.items():
            if meth not in pmethods:
                faults.append(f"{name}.{meth} missing")
                continue
            faults += [f"{name}.{meth}({p}=...) missing"
                       for p in _narrowed(module, f"{name}.{meth}", mparams, pmethods[meth])]
    assert not faults, f"{module}: " + "; ".join(faults)


def test_every_stated_deviation_is_still_a_deviation():
    """A deviation the port has since closed leaves the lists."""
    for module, name in MISSING:
        assert name in public_api(REF / module) and name not in public_api(PORT / module), \
            (module, name)
    for module, func, param in NARROWED:
        ref, port = public_api(REF / module)[func], public_api(PORT / module)[func]
        assert param in ref[1][0] and param not in port[1][0], (module, func, param)


def test_port_adds_only_its_own_modules():
    """Modules of the port with no reference counterpart: the package marker,
    the device helper, the kernels' build and the weight converter."""
    extra = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                   if not (REF / p.relative_to(PORT)).exists())
    assert extra == ["__init__.py", "device.py", "kernels/_build.py",
                     "models/convert.py"], extra


def test_roofline_chips_is_the_default_mesh():
    """The reference's ``CHIPS`` is its mesh's size (a 16 x 16 pod); the
    port's default mesh is one H100."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import chips

    assert roofline.CHIPS == chips(roofline.one_chip()) == 1


def test_analyze_pair_carries_dryrun_mem(monkeypatch):
    """``dryrun_mem`` lands in the record as ``mem_per_device``, as in the
    reference (``src/repro/launch/roofline.py::analyze_pair``); a skipped
    pair is skipped before any measurement."""
    from repro_torch.launch import roofline

    monkeypatch.setattr(roofline, "analyze",
                        lambda cfg, shape, mesh=None: {"arch": cfg.name, "status": "ok"})
    mem = {"argument": 123.0}
    rec = roofline.analyze_pair("granite-3-2b", "train_4k", dryrun_mem=mem)
    assert rec["mem_per_device"] == mem and rec["status"] == "ok"
    assert "mem_per_device" not in roofline.analyze_pair("granite-3-2b", "train_4k")
    assert roofline.analyze_pair("granite-3-2b", "long_500k",
                                 dryrun_mem=mem)["status"] == "skipped"
