"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper's
``wgmma``/``setmaxnreg`` target; plain ``sm_90`` refuses those) into an
object, all sources at once in parallel, and the objects are linked into one
shared library with a plain C interface; nothing includes PyTorch's headers,
the slow part of building a PyTorch extension.  The library lands in
``build/torch_kernels/<hash>/`` under the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from disk.

A failed build raises :class:`KernelBuildError`; nothing here falls back to
the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libtdt_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points and their argument types: every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "tdt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                            _F, _I, _P],
    "tdt_decode_attention": [*[_P] * 10, *[_I] * 9, _F, _F, _I, _P],
    "tdt_decode_cluster": [*[_P] * 4, _I, _I, *[_P] * 4, *[_I] * 7, _F, _F, _P],
    "tdt_fused_attn_decode": [*[_P] * 19, *[_I] * 11, _F, _F, _F, _I, _I, _P],
    "tdt_fused_attn_decode_blocks_per_sm": [_I, _I, _I, _I],
    "tdt_grouped_matmul": [*[_P] * 4, *[_I] * 9, _P],
    "tdt_grouped_schedule": [_P, _I, _I, _I, _P, _P],
    "tdt_grouped_units": [_P, _I, _I, _I, _P, _P],
    "tdt_matmul": [_P, _P, _P, *[_I] * 8, _P],
    "tdt_decode_attention_state": [*[_P] * 10, *[_I] * 9, _F, _F, _I, _P],
    "tdt_flash_attention_chunk": [*[_P] * 11, *[_I] * 9, _F, _F, _I, _P],
    # the collectives take a pointer to their CollArgs (core/symm.py), which
    # the C side copies into the launch by value
    "tdt_all_gather": [_P, _P],
    "tdt_reduce_scatter": [_P, _P],
    "tdt_all_reduce": [_P, _P],
    "tdt_coll_wait_record": [_P],
    # the overlapped GEMMs take a pointer to their GemmArgs (core/symm.py)
    "tdt_ag_gemm": [_P, _I, _P],
    "tdt_gemm_rs": [_P, _P],
    "tdt_gemm_ar": [_P, _P],
    # K12's and K13's main loop alone, a rank-stacked product (x, w, y, R, M,
    # K, N, dtype, out_dtype, stream): chip_smoke.py's chains only
    "tdt_wgmma_product": [_P, _P, _P, *[_I] * 6, _P],
    # K14's ring loop alone, with the same arguments: chip_smoke.py's chain
    "tdt_ring_product": [_P, _P, _P, *[_I] * 6, _P],
    # K15 and K16 take a pointer to their FusedArArgs / PersistentArgs
    "tdt_fused_ar": [_P, _I, _P],
    "tdt_fused_ar_lanes": [_I, _I, _I, _I, _I],
    "tdt_persistent_decode": [_P, _I, _I, _P],
    "tdt_persistent_lanes": [_I, _I, _I, _I],
    # K16's served form (bf16, head dim 128) takes a pointer to its StreamArgs
    "tdt_persistent_v2": [_P, _I, _P],
    "tdt_persistent_v2_lanes": [_I, _I],
    # K17 takes a pointer to its A2aArgs (core/symm.py)
    "tdt_all_to_all": [_P, _P],
    "tdt_quant_pack": [_P, _P, _L, _I, _I, _I, _F, _P],
    "tdt_overlap_probe": [_P, _P, _P, *[_I] * 8, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile and link the kernels if this source hash has no library yet.
    Returns (library path, compiler log; empty when the library existed)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(cmd[-3])
        if failed:
            raise KernelBuildError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
               *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            raise KernelBuildError("nvcc link failed:\n" + "\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    text = "\n".join(log)
    (out_dir / "nvcc.log").write_text(text)
    return lib, text


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call in a process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
