"""LM substrate: config, shared layers and the dense transformer."""
