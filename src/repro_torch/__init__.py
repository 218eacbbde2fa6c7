"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same layout and public names as ``repro``; imports ``torch`` and never
``jax`` or any ``repro`` module.  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""
