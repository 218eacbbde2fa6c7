"""Hand-written Hopper kernels (``csrc/*.cu``), their plain torch versions,
the oracles (``ref.py``) and the dispatch (``ops.py``)."""
