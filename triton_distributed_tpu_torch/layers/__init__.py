"""Layer building blocks: RMSNorm, the attention / MLP parameters at tp = 1
and sharded over a mesh of co-located ranks, and the MoE layer."""
