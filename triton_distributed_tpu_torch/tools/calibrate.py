"""Size crossovers of the collectives' method choice.

Counterpart of ``triton_distributed_tpu/tools/calibrate.py``, of which only
the two thresholds are ported, at their cold defaults: the JAX package
replaces them with a measured link's bandwidth-delay product.  Ranks
co-located on one card exchange through device memory, not a link, so a
calibration there would measure the wrong thing; it comes with the host
that runs one process per card.
"""

from __future__ import annotations

DEFAULT_PUSH_BYTES = 256 * 1024
DEFAULT_ONE_SHOT_BYTES = 512 * 1024


def push_bytes_threshold() -> int:
    """AllGather one-shot push vs ring crossover, in bytes per shard."""
    return DEFAULT_PUSH_BYTES


def one_shot_bytes_threshold() -> int:
    """AllReduce one-shot vs two-shot crossover, in bytes per rank."""
    return DEFAULT_ONE_SHOT_BYTES
