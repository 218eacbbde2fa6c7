"""Decoder-only LM as ``nn.Module`` parameter holders + functions."""
