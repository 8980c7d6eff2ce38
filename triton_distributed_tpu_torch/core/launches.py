"""Launch counters of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else (a CPU tensor, which takes the plain version, counts
nothing), so a caller can show that a run went through the kernels: reset,
run, read.  A wrapper whose kernel serves several products of a path also
names the product's form (its shape), which is counted beside the total,
so the launches of each form are read from the counter as well.  K14's and
K15's forms start with their reduction, "one_shot" or "ring"
(``ops/fused_decode.py::FORM_NAMES``): a K14 one-shot launch runs K15's
linear kernel but counts as K14.
"""

from __future__ import annotations

KERNELS = (
    "flash_attention",               # K1
    "decode_attention",              # K2
    "paged_decode_attention",        # K3, full-precision pages
    "paged_decode_attention_int8",   # K3, int8 pages
    "fused_attn_decode",             # K4, full-precision pages
    "fused_attn_decode_int8",        # K4, int8 pages
    "grouped_matmul",                # K5
    "matmul",                        # K6
    "decode_attention_state",        # K7, contiguous cache
    "paged_decode_attention_state",  # K7, full-precision pages
    "paged_decode_attention_state_int8",  # K7, int8 pages
    "flash_attention_chunk",         # K8
    "all_gather",                    # K9, form (method, n, shard shape)
    "reduce_scatter",                # K10, form ("ring", n, shard shape)
    "all_reduce",                    # K11, form (method, n, shard shape)
    "ag_gemm",                       # K12, form (ring, n, A shard, B shard)
    "gemm_rs",                       # K13, form ("ring", n, A shard, B shard)
    "gemm_ar",                       # K14, form (reduction, n, A shard, B shard)
    "fused_mlp_ar",                  # K15 swiglu, form (reduction, n, B, K, F / n, N)
    "fused_linear_ar",               # K15 linear, form (reduction, n, B, F / n, N)
    "persistent_decode",             # K16, form (n, layers, B, K)
    "all_to_all",                    # K17, form (role, n, T or zone rows, row bytes)
    "quant_pack",                    # K18, form (wire dtype, rows, H)
    "overlap_probe",                 # K19, form (mode, m, n, k)
)

_counts = dict.fromkeys(KERNELS, 0)
_forms: dict[tuple[str, tuple], int] = {}


def count(name: str, form: tuple | None = None) -> None:
    _counts[name] += 1
    if form is not None:
        _forms[name, form] = _forms.get((name, form), 0) + 1


def reset_launch_counts() -> None:
    for name in _counts:
        _counts[name] = 0
    _forms.clear()


def launch_counts() -> dict[str, int]:
    return dict(_counts)


def launch_forms() -> dict[tuple[str, tuple], int]:
    """Launches by ``(kernel, form)``, for the wrappers that name a form."""
    return dict(_forms)
