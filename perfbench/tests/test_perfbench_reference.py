"""The frozen plain reference against the port on the CPU at SMOKE size:
the same weights from the engine's seed, bit for bit; the prefill's and
each decode step's logits within 1e-4 (both float32, the port's plain
kernels against the reference's einsums); and the fp8 control away from
them by more than the cells' rounding."""
import numpy as np
import pytest
import torch

import _harness  # noqa: F401  (puts perfbench/ and src/ on the path)


@pytest.mark.parametrize("cell", ["granite-3-2b.docs-b80", "starcoder2-15b.code-b64"])
def test_reference_matches_the_port(cell):
    from benchlib import check, spec
    from benchlib.reference import DenseLM
    from repro_torch.models import registry

    config = spec.load_cell(cell, smoke=True).config
    bundle = registry.build_arch(config["program_arch"], smoke=True, max_seq=24, device="cpu")
    params = bundle.init(torch.Generator(device="cpu").manual_seed(check.ENGINE_SEED))
    ref = DenseLM(config, device="cpu", seed=check.ENGINE_SEED)
    state = params.state_dict()
    assert torch.equal(state["embed"], ref.embed)
    for i, layer in enumerate(ref.layers):
        names = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv", "wo": "attn.wo",
                 "wi": "ffn.wi", "w2": "ffn.wo", "wg": "ffn.wg"}
        for mine, theirs in names.items():
            if mine in layer:
                assert torch.equal(state[f"blocks.{i}.{theirs}"], layer[mine])

    rng = np.random.default_rng(5)
    prompts = rng.integers(0, config["vocab_size"], (3, 24)).astype(np.int32)
    with torch.inference_mode():
        logits, caches, pos = bundle.prefill(params, {"tokens": torch.from_numpy(prompts).long()})
        steps, tok = [logits], logits.argmax(-1)
        served = [tok]
        for i in range(3):
            logits, caches = bundle.decode_step(params, caches, tok, pos + i)
            steps.append(logits)
            tok = logits.argmax(-1)
            served.append(tok)
    got = torch.stack(steps, 1)                                   # (3, 4, V)
    served = torch.stack(served, 1).numpy()                       # each step's argmax
    want = ref.logits(prompts, served)
    assert (got - want).abs().max() < 1e-4
    assert check.widest_gap(want, served) == 0.0
    control = ref.logits(prompts, served, precision="fp8")
    assert (control - want).abs().max() > 1e-2
