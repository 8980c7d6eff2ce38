"""Contextual autotuner (counterpart of ``triton_distributed_tpu/tune``)."""

from .autotuner import (
    Autotuner,
    LibraryBackend,
    TileInfeasible,
    TuneResult,
    autotune,
    fresh_tune_matmul,
    lookup_winner,
    matmul_tile_candidates,
    resolve_config,
    transparent_tuning_enabled,
    tuned_matmul,
)

__all__ = [
    "Autotuner", "LibraryBackend", "TileInfeasible", "TuneResult", "autotune",
    "fresh_tune_matmul", "lookup_winner", "matmul_tile_candidates",
    "resolve_config", "transparent_tuning_enabled", "tuned_matmul",
]
