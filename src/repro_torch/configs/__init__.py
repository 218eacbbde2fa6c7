"""Per-architecture configs (one module per assigned architecture).

Each module defines ``CONFIG: repro_torch.config.ModelConfig`` with the exact
assigned dimensions, citing its source, plus ``SMOKE`` (the reduced variant
used by CPU smoke tests).
"""
from repro_torch.config import ARCH_IDS  # noqa: F401
