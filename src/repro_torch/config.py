"""Configuration system for the PyTorch port (a copy of ``repro.config``).

Every assigned architecture is described by a frozen ``ModelConfig``; the four
assigned input shapes by ``InputShape``.  Architecture configs live in
``repro_torch.configs.<arch_id>`` (one module per arch, citing its source), and are
resolved lazily through :func:`get_config` so that importing ``repro_torch.config``
never pulls in model code.

The reduced ("smoke") variant used by CPU tests is derived mechanically via
:func:`reduced` — 2 layers, d_model <= 512, <= 4 experts — so smoke tests always
exercise the same code path as the full config.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# --------------------------------------------------------------------------- #
# Architecture configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts settings (Switch-style capacity dispatch)."""

    num_experts: int
    top_k: int
    expert_ff: int                  # per-expert FFN hidden dim
    every_n_layers: int = 1         # MoE layer every n layers (Jamba: 2)
    dense_residual: bool = False    # Arctic: dense FFN branch parallel to experts
    dense_residual_ff: int = 0      # hidden dim of the dense residual branch
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Selective-SSM (Mamba) block settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block-stack settings (sLSTM + mLSTM interleave)."""

    slstm_every: int = 2            # pattern period: [mLSTM, sLSTM] when 2
    proj_factor: float = 2.0        # up-projection factor inside blocks
    num_heads: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder (conv/mel frontend stubbed)."""

    num_layers: int = 32
    num_frames: int = 1500          # encoder sequence length after conv stub
    d_model: int = 1280
    num_heads: int = 20
    d_ff: int = 5120


@dataclass(frozen=True)
class VisionConfig:
    """ViT frontend stub for VLMs: patch embeddings are provided as inputs."""

    num_image_tokens: int = 256     # tokens per image after projector
    d_embed: int = 896              # projector output == LM d_model


@dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------- #
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    source: str                     # citation for the numbers below
    # transformer dims ------------------------------------------------------ #
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    d_ff: int = 0                   # 0 -> no dense FFN (xLSTM)
    vocab_size: int = 0
    # attention flavour ------------------------------------------------------ #
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None     # SWA width (h2o-danube; jamba@500k)
    # block pattern ----------------------------------------------------------- #
    # 'A' attention+FFN, 'M' mamba, 'S' sLSTM, 'L' mLSTM. Tiled over num_layers.
    block_pattern: str = "A"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # numerics ---------------------------------------------------------------- #
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "bfloat16"   # parameter dtype (fp32 master in optimizer)
    # execution --------------------------------------------------------------- #
    attention_impl: str = "reference"   # reference | pallas: the hand kernel
                                        # (plain torch on CPU); oracle: ref.py
    remat: bool = True              # activation checkpointing in train_step
    unroll_layers: bool = False     # roofline analysis: materialise the layer
                                    # loop so cost_analysis counts every layer
    full_param_count: int = 0       # set by roofline's scaled variants so
                                    # sharding guards see the real model size

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_kv_heads == 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    # derived ----------------------------------------------------------- #
    @property
    def layer_pattern(self) -> str:
        """The per-layer block kind string, tiled to num_layers."""
        pat = self.block_pattern
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Which layers carry a routed-MoE FFN.

        Block anatomy: every layer is ``mixer (A/M/S/L per block_pattern) +
        FFN``; the FFN is routed-MoE on every ``every_n_layers``-th layer and
        a dense FFN (if d_ff > 0) otherwise.  Jamba places MoE on every other
        layer regardless of mixer kind, which this reproduces.
        """
        if self.moe is None:
            return tuple(False for _ in range(self.num_layers))
        n = self.moe.every_n_layers
        return tuple(i % n == n - 1 for i in range(self.num_layers))

    # parameter counting (for roofline MODEL_FLOPS = 6·N·D) -------------- #
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        emb = self.vocab_size * d
        n += emb
        if not self.tie_embeddings:
            n += emb
        moe_mask = self.moe_layer_mask()
        ff_mults = 3 if self.act == "swiglu" else 2
        for i, kind in enumerate(self.layer_pattern):
            # FFN half (shared by every mixer kind except xLSTM's d_ff == 0)
            if moe_mask[i]:
                m = self.moe
                k = m.top_k if active_only else m.num_experts
                n += k * ff_mults * d * m.expert_ff
                n += d * m.num_experts  # router
                if m.dense_residual:
                    n += ff_mults * d * (m.dense_residual_ff or self.d_ff)
            elif self.d_ff:
                n += ff_mults * d * self.d_ff
            if self.d_ff or moe_mask[i]:
                n += d  # FFN pre-norm
            # mixer half
            if kind == "A":
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
                n += d  # norm
            elif kind == "M":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                n += d * 2 * d_in            # in_proj (x and z)
                n += d_in * s.d_conv         # depthwise conv
                n += d_in * (dt_rank + 2 * s.d_state)  # x -> dt, B, C
                n += dt_rank * d_in          # dt proj
                n += d_in * s.d_state        # A
                n += d_in                    # D
                n += d_in * d                # out proj
                n += d                       # norm
            elif kind in ("S", "L"):
                x = self.xlstm or XLSTMConfig()
                d_in = int(x.proj_factor * d)
                n += 2 * d * d_in            # up projections
                n += 4 * d_in * d_in // x.num_heads  # gates (blocked per head)
                n += d_in * d                # down proj
                n += d
        if self.encoder is not None:
            e = self.encoder
            per = e.d_model * e.d_model * 4 + 2 * e.d_model * e.d_ff + 4 * e.d_model
            n += e.num_layers * per
            # decoder cross-attention (added on top of self-attn counted above)
            n += self.num_layers * (2 * d * self.kv_dim + d * self.q_dim + self.q_dim * d)
        return n


# --------------------------------------------------------------------------- #
# Input shapes
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "starcoder2_15b",
    "jamba_v01_52b",
    "qwen25_14b",
    "whisper_large_v3",
    "h2o_danube3_4b",
    "internvl2_1b",
    "qwen3_moe_30b_a3b",
    "xlstm_125m",
    "arctic_480b",
    "granite3_2b",
)

# external ids ("--arch starcoder2-15b") -> module names
_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({
    "starcoder2-15b": "starcoder2_15b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen2.5-14b": "qwen25_14b",
    "whisper-large-v3": "whisper_large_v3",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "internvl2-1b": "internvl2_1b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "xlstm-125m": "xlstm_125m",
    "arctic-480b": "arctic_480b",
    "granite-3-2b": "granite3_2b",
})


def canonical_arch_id(arch: str) -> str:
    key = arch.strip()
    if key in ARCH_IDS:
        return key
    if key in _ALIAS:
        return _ALIAS[key]
    key2 = key.replace("-", "_").replace(".", "")
    if key2 in ARCH_IDS:
        return key2
    raise KeyError(f"unknown architecture {arch!r}; known: {sorted(_ALIAS)}")


def get_config(arch: str) -> ModelConfig:
    """Load ``repro_torch.configs.<arch>.CONFIG`` lazily."""
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch_id(arch)}")
    return mod.CONFIG


def get_shape(shape: str) -> InputShape:
    return SHAPES[shape]


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k needs sub-quadratic attention (SSM/hybrid/SWA)."""
    if shape.name != "long_500k":
        return True
    if cfg.family in ("ssm",):
        return True
    if cfg.family == "hybrid":
        return True
    return cfg.sliding_window is not None


# --------------------------------------------------------------------------- #
# Reduced (smoke) variants
# --------------------------------------------------------------------------- #


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Shrink a config to CPU-smoke scale while preserving its family/shape
    of computation (same code path: GQA ratio, MoE, pattern, enc-dec, ...)."""
    assert d_model <= 512
    ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    heads = 4
    kv = max(1, heads // ratio)
    head_dim = max(8, d_model // heads)
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab_size=vocab,
        sliding_window=None if cfg.sliding_window is None else 64,
        param_dtype="float32",
        dtype="float32",
        remat=False,
    )
    if cfg.moe is not None:
        # capacity_factor = E/k -> capacity == group size -> nothing drops.
        # Dropping couples tokens non-causally (a future token can evict an
        # earlier one), which would break the decode == full-forward
        # invariant the smoke tests assert.
        kw["moe"] = replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            expert_ff=d_model * 2,
            capacity_factor=4.0 / min(cfg.moe.top_k, 2) * 2,
            dense_residual_ff=d_model * 2 if cfg.moe.dense_residual else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=8)
    if cfg.xlstm is not None:
        kw["xlstm"] = replace(cfg.xlstm, num_heads=2)
    if cfg.encoder is not None:
        kw["encoder"] = replace(
            cfg.encoder, num_layers=layers, num_frames=32, d_model=d_model,
            num_heads=heads, d_ff=d_model * 2,
        )
    if cfg.vision is not None:
        kw["vision"] = replace(cfg.vision, num_image_tokens=8, d_embed=d_model)
    # keep layer pattern valid for tiny layer counts
    if cfg.block_pattern != "A":
        pat = cfg.layer_pattern[: layers]
        # guarantee at least one of each block kind present in the pattern
        kinds = sorted(set(cfg.block_pattern))
        pat = "".join(kinds[i % len(kinds)] for i in range(layers))
        kw["block_pattern"] = pat
    return replace(cfg, **kw)


def reduced_shape(shape: InputShape, *, seq: int = 64, batch: int = 2) -> InputShape:
    return InputShape(shape.name + "_smoke", seq, batch, shape.kind)


def describe(cfg: ModelConfig) -> str:
    n = cfg.param_count()
    na = cfg.param_count(active_only=True)
    s = f"{cfg.name} [{cfg.family}] {cfg.num_layers}L d={cfg.d_model} " \
        f"H={cfg.num_heads}/kv{cfg.num_kv_heads} ff={cfg.d_ff} V={cfg.vocab_size} " \
        f"params={n/1e9:.2f}B"
    if cfg.moe:
        s += f" (active={na/1e9:.2f}B, {cfg.moe.num_experts}e top-{cfg.moe.top_k})"
    return s
