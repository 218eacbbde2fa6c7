"""Model registry (port of ``repro.models.registry``): config ->
``ModelBundle`` (init / loss / prefill / decode) for decoder-only and
encoder-decoder configs.

The bundle is the entry surface of the serving engine, the trainer and the
dry run.  ``input_specs`` returns meta tensors (shape and dtype, no storage),
which play the part of the reference's ``jax.ShapeDtypeStruct`` stand-ins,
for every model input of a given input shape.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import InputShape, ModelConfig, canonical_arch_id
from repro_torch.device import resolve_device
from repro_torch.models import attention, encdec, lm, layers, transformer


def resolve_window(cfg: ModelConfig, shape: Optional[InputShape]) -> Optional[int]:
    """Sliding-window width for this (arch, shape).

    Jamba's attention layers switch to a 4096 window at the long_500k shape;
    SWA archs use their config window everywhere.
    """
    if cfg.sliding_window is not None:
        return cfg.sliding_window
    if cfg.family == "hybrid" and shape is not None and shape.seq_len > 262_144:
        return 4096
    return None


Model = Union[lm.LM, encdec.EncDec]


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    shape: Optional[InputShape]
    max_seq: int
    window: Optional[int]
    device: torch.device
    init: Callable[[torch.Generator], Model]
    loss: Callable[[Model, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]]
    prefill: Callable[[Model, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Any, int]]
    decode_step: Callable[[Model, Any, torch.Tensor, Any], Tuple[torch.Tensor, Any]]

    def empty(self) -> Model:
        """The model's parameters on the meta device, for
        ``load_state_dict(state, assign=True)``."""
        if self.cfg.encoder is not None:
            return encdec.EncDec(self.cfg, max_seq=self.max_seq, device="meta")
        return lm.LM(self.cfg, device="meta")

    def params_spec(self) -> Dict[str, torch.Tensor]:
        """The parameters as meta tensors, by ``state_dict`` name."""
        return self.empty().state_dict()

    def decode_caches_spec(self, batch: int):
        """The decode caches of ``batch`` rows as meta tensors."""
        return _init_caches(self.cfg, batch, self.max_seq, self.window, device="meta")

    def input_specs(self) -> Dict[str, Any]:
        """Meta-tensor stand-ins for the shape's entry point."""
        if self.shape is None:
            raise ValueError("input_specs needs a bundle built with an input shape")
        return input_specs(self.cfg, self.shape)


def _init_caches(cfg, batch, max_seq, window, *, device):
    """Zero decode caches in the port's layout: one per layer (attention
    ``{"k", "v"}``, or a recurrent state); the encoder-decoder's
    ``{"self": [...], "cross": [...]}``, one ``{"k", "v"}`` a decoder layer."""
    if cfg.encoder is not None:
        shape = (batch, cfg.encoder.num_frames, cfg.num_kv_heads, cfg.head_dim)
        dt = layers.dt(cfg.dtype)
        return {
            "self": [attention.init_cache(cfg, batch, max_seq, device=device)
                     for _ in range(cfg.num_layers)],
            "cross": [{"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}
                      for _ in range(cfg.num_layers)],
        }
    return transformer.init_decode_caches(cfg, batch, max_seq, window=window, device=device)


def build(cfg: ModelConfig, shape: Optional[InputShape] = None, *,
          max_seq: Optional[int] = None,
          device: Union[str, torch.device] = "cuda") -> ModelBundle:
    dev = resolve_device(device)
    window = resolve_window(cfg, shape)
    mseq = max_seq or (shape.seq_len if shape else 2048)
    if cfg.encoder is not None:
        return ModelBundle(
            cfg=cfg, shape=shape, max_seq=mseq, window=window, device=dev,
            init=lambda gen: encdec.init_encdec(gen, cfg, max_seq=mseq, device=dev),
            loss=lambda p, b: encdec.encdec_loss(p, cfg, b),
            prefill=lambda p, b: encdec.encdec_prefill(p, cfg, b, max_seq=mseq),
            decode_step=lambda p, c, t, pos: encdec.encdec_decode_step(p, cfg, c, t, pos),
        )
    transformer._block_meta(cfg)   # a bad pattern fails here, not mid-init
    return ModelBundle(
        cfg=cfg, shape=shape, max_seq=mseq, window=window, device=dev,
        init=lambda gen: lm.init_lm(gen, cfg, max_seq=mseq, device=dev),
        loss=lambda p, b: lm.lm_loss(p, cfg, b, window=window),
        prefill=lambda p, b: lm.lm_prefill(p, cfg, b, max_seq=mseq, window=window),
        decode_step=lambda p, c, t, pos: lm.lm_decode_step(p, cfg, c, t, pos,
                                                           window=window),
    )


def build_arch(arch: str, shape: Optional[InputShape] = None, *, smoke: bool = False,
               max_seq: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> ModelBundle:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch_id(arch)}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return build(cfg, shape, max_seq=max_seq, device=device)


# --------------------------------------------------------------------------- #
# input specs (dry-run stand-ins)
# --------------------------------------------------------------------------- #


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta tensors for the given entry point — no allocation."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = layers.dt(cfg.dtype)
    window = resolve_window(cfg, shape)

    def meta(size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")

    def batch_specs(with_labels: bool) -> Dict[str, Any]:
        d: Dict[str, Any] = {"tokens": meta((b, s), i32)}
        if with_labels:
            d["labels"] = meta((b, s), i32)
        if cfg.encoder is not None:
            d["frames"] = meta((b, cfg.encoder.num_frames, cfg.encoder.d_model), act)
        if cfg.vision is not None:
            d["image_embeds"] = meta((b, cfg.vision.num_image_tokens, cfg.vision.d_embed), act)
        return d

    if shape.kind == "train":
        return {"batch": batch_specs(True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(False)}
    # decode: one new token against a seq_len cache
    return {
        "caches": _init_caches(cfg, b, s, window, device="meta"),
        "token": meta((b,), i32),
        "pos": meta((), i32),
    }
