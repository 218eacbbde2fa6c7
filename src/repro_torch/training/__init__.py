"""Training substrate (port of ``repro.training``): the optimizer, the train
step and loop, and checkpointing."""
