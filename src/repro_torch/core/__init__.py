"""Platform-agnostic pieces of the port (cold-start phases)."""
