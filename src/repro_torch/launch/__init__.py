"""Launchers (port of ``repro.launch``): serve, train, the meshes, the
partition specs, the dry run and the roofline."""
