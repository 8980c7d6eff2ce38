"""Per-source nvcc wall times of the kernel library, for one or more checkouts;
and, with ``--sass``, whether two checkouts build each kernel to the same SASS.

Every ``csrc/*.cu`` of a checkout is compiled at once, as
``core/build.py::build`` starts them (one nvcc a source, this package's
flags), and the seconds until each finishes are printed, slowest first, one
JSON line a checkout.  The slowest source is the build's critical path.

    python3 scripts/torch_build_times.py [--sass] TREE [TREE ...]

TREE is a checkout's root (``.`` for this one; a ``git archive`` of another
commit unpacked under ``build/``).  Name a tree more than once to time the
trees in turns (parent, change, change, parent).  Objects go to a temporary
directory.  With ``--sass`` the objects of the first two distinct trees are
kept, ``cuobjdump -sass`` splits each into its kernels by (mangled) name,
and one more JSON line gives, for the kernels both trees build, how many
have the same SASS text, how many more are the same once the slots of
constant bank 4 are masked (the addresses of global variables, which the
linker fills and whose order follows the source file), which differ even
then (with the source each tree builds it from and their first differing
lines), and the kernels only one tree builds.  A kernel keeps its name when
it moves to another source, so a split source is held to the kernels it
came from; the hash that names a source's anonymous namespace (it follows
the file's path) is masked in names and text.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from triton_distributed_tpu_torch.core import build  # noqa: E402


def source_times(tree: Path, keep: Path | None = None) -> dict:
    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        objdir = keep or Path(tmp)
        objdir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {src.name: subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-c", str(src), "-o", str(objdir / f"{src.stem}.o")],
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


# the anonymous namespace of a source: <length>_GLOBAL__N__<hash>_<length>_<file>_cu_<hash>
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
# an instruction's encoding comment, and a slot of constant bank 4
ENCODING = re.compile(r"/\* 0x[0-9a-f]{16} \*/")
BANK4 = re.compile(r"c\[0x4\]\[0x[0-9a-f]+\]")


def kernels_sass(objdir: Path) -> dict[str, tuple[str, str]]:
    """{kernel name: (source object, its SASS text)} of every object, the
    anonymous namespaces' hashes masked."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    out = {}
    for obj in sorted(objdir.glob("*.o")):
        text = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True, text=True,
                              check=True, timeout=600).stdout
        name, body = None, []
        for ln in [*text.splitlines(), "Function : "]:
            if "Function : " in ln:
                if name:
                    out[name] = (obj.stem, "\n".join(body))
                name, body = ANON.sub("<anon>", ln.split("Function : ")[1].strip()), []
            elif name:
                body.append(ANON.sub("<anon>", ln.rstrip()))
    return out


def masked(text: str) -> list[str]:
    return [BANK4.sub("c[0x4][*]", ENCODING.sub("", ln)).rstrip() for ln in text.splitlines()]


def compare_sass(a: Path, b: Path) -> dict:
    ka, kb = kernels_sass(a), kernels_sass(b)
    both = sorted(set(ka) & set(kb))
    same = [k for k in both if ka[k][1] == kb[k][1]]
    bank4 = [k for k in both if k not in same and masked(ka[k][1]) == masked(kb[k][1])]
    differ = []
    for k in both:
        if k not in same and k not in bank4:
            la, lb = masked(ka[k][1]), masked(kb[k][1])
            lines = [[x, y] for x, y in zip(la, lb) if x != y][:4]
            differ.append({"kernel": k, "sources": [ka[k][0], kb[k][0]],
                           "lines": [len(la), len(lb)], "first_differences": lines})
    by_source: dict = {}
    for k in same + bank4:
        key = f"{ka[k][0]} -> {kb[k][0]}"
        by_source[key] = by_source.get(key, 0) + 1
    return {"sass": {"a": str(a), "b": str(b), "kernels_in_both": len(both),
                     "same": len(same), "same_but_bank4": len(bank4),
                     "same_by_source": by_source, "differ": differ,
                     "only_in_a": sorted(set(ka) - set(kb)),
                     "only_in_b": sorted(set(kb) - set(ka))}}


if __name__ == "__main__":
    args = sys.argv[1:]
    sass = "--sass" in args
    trees = [Path(a) for a in args if a != "--sass"]
    if not trees:
        sys.exit(__doc__)
    with tempfile.TemporaryDirectory() as keep_root:
        kept: dict = {}
        for tree in trees:
            key = str(tree.resolve())
            keep = None
            if sass and key not in kept and len(kept) < 2:
                keep = kept[key] = Path(keep_root) / str(len(kept))
            print(json.dumps(source_times(tree, keep)), flush=True)
        if sass and len(kept) == 2:
            print(json.dumps(compare_sass(*kept.values())), flush=True)
