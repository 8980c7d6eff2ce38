"""Layer building blocks at tp = 1: RMSNorm and the attention / MLP parameters."""
