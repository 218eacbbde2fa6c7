"""Training substrate: the optimizer and checkpointing (the train loop comes
with the training slice of the port, ROADMAP A6)."""
