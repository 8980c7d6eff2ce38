"""Launch counters of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else (a CPU tensor, which takes the plain version, counts
nothing), so a caller can show that a run went through the kernels: reset,
run, read.
"""

from __future__ import annotations

KERNELS = (
    "flash_attention",               # K1
    "decode_attention",              # K2
    "paged_decode_attention",        # K3, full-precision pages
    "paged_decode_attention_int8",   # K3, int8 pages
    "fused_attn_decode",             # K4, full-precision pages
    "fused_attn_decode_int8",        # K4, int8 pages
)

_counts = dict.fromkeys(KERNELS, 0)


def count(name: str) -> None:
    _counts[name] += 1


def reset_launch_counts() -> None:
    for name in _counts:
        _counts[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_counts)
