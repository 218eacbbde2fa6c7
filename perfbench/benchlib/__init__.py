"""The benchmark's own code: the yardstick that measures ``repro_torch``.

``spec`` reads ``BENCHMARK.json`` and the files it names, ``traffic`` turns a
traffic mix into requests, ``endpoint`` drives the program's router,
``trace`` reads the profiler, ``work`` counts operations and bytes from
shapes, ``reference`` is the plain PyTorch model that decides ``correct``,
and ``run`` ties one run of one cell together.  Nothing here imports JAX or
the JAX package; only ``endpoint`` and ``run`` import the program.
"""
