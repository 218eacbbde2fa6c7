"""Launchers (port of ``repro.launch``): the serve entrypoint."""
