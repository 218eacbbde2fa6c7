"""Model registry (port of ``repro.models.registry``): config ->
``ModelBundle`` (init / loss / prefill / decode) for decoder-only and
encoder-decoder configs.

The bundle is the entry surface of the serving engine and the trainer.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import InputShape, ModelConfig, canonical_arch_id
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm, transformer


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
