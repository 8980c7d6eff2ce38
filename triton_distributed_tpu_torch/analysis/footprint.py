"""Static resource footprint of a kernel configuration on Hopper
(counterpart of ``triton_distributed_tpu/analysis/footprint.py``, the
matmul family only).

The JAX calculator checks a tile's VMEM working set against Mosaic's scoped
budget (``:102``, ``:349``).  A Hopper block has no VMEM; what bounds a
tile is the shared memory of its pipeline stages (227 KB a block: K6's
bf16 ring of TMA stages and its alignment slack) and the registers of its
accumulators (255 a thread of the consumer warpgroups at most, with room
left for addresses and loop state).  A tile must also be one the kernel is
built for: K6 instantiates a fixed set (``ops.matmul.KERNEL_TILES``).  The
tuner drops a candidate this finds a problem with before measuring anything
(``tune.autotuner.prune_infeasible``).
"""

from __future__ import annotations

import dataclasses

SMEM_PER_BLOCK = 232_448   # 227 KB: the most a block may opt in to on an H100
REG_LIMIT = 255            # registers a thread may hold
REG_HEADROOM = 64          # left for fragments, addresses and loop state


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Per-block resources of one kernel configuration."""

    smem_bytes: int
    acc_regs: int   # f32 accumulator registers a thread holds


def matmul(cfg, m: int, n: int, k: int, dtype, out_dtype=None) -> Footprint | None:
    """K6's footprint for the tile ``cfg`` ((bm, bn, bk) or an object with
    ``.bm/.bn/.bk``) at operands of ``dtype``, or None if K6 has no such
    tile."""
    del m, n, k, out_dtype
    from ..ops import matmul as mm

    tile = _tile3(cfg)
    spec = mm.KERNEL_TILES.get(dtype, {}).get(tile)
    if spec is None:
        return None
    return Footprint(smem_bytes=spec.smem_bytes(*tile),
                     acc_regs=tile[0] * tile[1] // spec.acc_threads)


def _tile3(cfg) -> tuple[int, int, int]:
    if isinstance(cfg, (tuple, list)):
        return tuple(int(x) for x in cfg[:3])
    return (cfg.bm, cfg.bn, cfg.bk)


def validate(fp: Footprint, label: str = "") -> list[str]:
    tag = f"{label}: " if label else ""
    out = []
    if fp.smem_bytes > SMEM_PER_BLOCK:
        out.append(f"{tag}{fp.smem_bytes} bytes of shared memory exceed the "
                   f"{SMEM_PER_BLOCK} a block may use")
    if fp.acc_regs > REG_LIMIT - REG_HEADROOM:
        out.append(f"{tag}{fp.acc_regs} accumulator registers a thread leave "
                   f"less than {REG_HEADROOM} of the {REG_LIMIT}")
    return out


FAMILY_FOOTPRINTS = {"matmul": matmul}


def config_feasible(family: str, cfg, dims: dict) -> list[str]:
    """Problems of (family, config) at ``dims`` (keyword arguments of the
    family's calculator: m, n, k, dtype); an empty list is feasible.
    Unknown families are feasible by definition (pruning must never have
    false positives)."""
    calc = FAMILY_FOOTPRINTS.get(family)
    if calc is None:
        return []
    label = f"{family}{_tile3(cfg)}"
    problems = [f"{label}: {d} = {dims[d]} is not a multiple of 8"
                for d in ("n", "k") if dims.get(d, 0) % 8]
    fp = calc(cfg, **dims)
    if fp is None:
        return problems + [f"{label}: no {dims.get('dtype')} kernel is built "
                           f"for this tile"]
    return problems + validate(fp, label)
