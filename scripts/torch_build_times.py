"""Per-source nvcc wall times of the kernel library, for one or more checkouts.

Every ``csrc/*.cu`` of a checkout is compiled at once, as
``core/build.py::build`` starts them (one nvcc a source, this package's
flags), and the seconds until each finishes are printed, slowest first, one
JSON line a checkout.  The slowest source is the build's critical path.

    python3 scripts/torch_build_times.py TREE [TREE ...]

TREE is a checkout's root (``.`` for this one; a ``git archive`` of another
commit unpacked under ``build/``).  Objects go to a temporary directory.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from triton_distributed_tpu_torch.core import build  # noqa: E402


def source_times(tree: Path) -> dict:
    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {src.name: subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-c", str(src), "-o", f"{tmp}/{src.stem}.o"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for src in sorted((tree / "triton_distributed_tpu_torch" / "csrc").glob("*.cu"))}
        done: dict = {}
        while len(done) < len(procs):
            for name, p in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = (round(time.perf_counter() - t0, 1), p.returncode)
            time.sleep(0.2)
        total = round(time.perf_counter() - t0, 1)
    return {"tree": str(tree), "total_s": total,
            "per_source": dict(sorted(done.items(), key=lambda kv: -kv[1][0]))}


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for arg in sys.argv[1:]:
        print(json.dumps(source_times(Path(arg))), flush=True)
