"""Where K17's and K11's one-shot time goes, on the card: %globaltimer stamps.

    python3 scripts/torch_coll_stamps.py [--tree DIR]     # one Hopper card

Copies the port package to build/stamps_coll/<variant>/ (git-ignored) and
builds, in parallel, only its csrc/collectives.cu and csrc/all_to_all.cu.  In
each copy, every statement of K17's kernel (``a2a_push_kernel``), K11's
(``all_reduce_kernel``) and the phases K11's one-shot calls (``push_phase``,
``one_shot_phase``) that moves data or flags is wrapped in %globaltimer reads
on thread 0 of each block, which sum each kind's time per block: the entry
barrier, the copies (puts), the fences, the credits (at device scope a
credit carries its own fence), the waits and the drains, the sum.  Thread 0
passes every __syncthreads of the block, so a kind's time includes the wait
for the block's other threads.  The variants:

- ``tree``: this checkout's kernels (the device-scope forms, and the
  system-scope forms of both kernels);
- ``barrier``: the same with the entry hub barrier put back into the
  device-scope forms, to show what the barrier costs;
- ``parent`` (with ``--tree DIR``, e.g. an unpacked ``git archive`` of an
  earlier commit): DIR's kernels, as they were.

Each variant runs in a child process and prints one JSON line per form: K17
dispatch and combine on bf16 (4096-byte) and packed u8 (2176-byte) rows at
Qwen3-30B-A3B's EP prefill (n = 4, 8192 rows a rank, 128 experts, uniform
random expert ids), and K11's one-shot at 4 x 4096 bf16, n = 4.  Each form's
output is first held bitwise to its plain version; then its time (CUDA events
with the stream held, ``core/utils.py::perf_func``), the kernel's span in the
last of 20 stamped launches (first block's start to last block's end), and
per kind the mean and max over blocks of its time a launch, in microseconds.
The tree's own kernels are untouched; the patch matches statements by the
callee's name and fails loudly when a kernel has none left to stamp.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "stamps_coll"
PKG = "triton_distributed_tpu_torch"
KEEP = ("collectives.cu", "all_to_all.cu")
# stamped functions per source file: (name, is the kernel itself)
FUNCS = {"all_to_all.cu": (("a2a_push_kernel", True),),
         "collectives.cu": (("all_reduce_kernel", True),),
         "ring.cuh": (("push_phase", False), ("one_shot_phase", False))}
# the callees whose statements are stamped, and their kind
LEAVES = {"collective_prologue": "barrier", "barrier_all": "barrier", "copy_units": "copy",
          "put_fence": "fence", "credit": "credit", "credit_each": "credit", "wait": "wait",
          "wait_each": "wait", "sum_units": "sum"}
KINDS = ("barrier", "copy", "fence", "credit", "wait", "sum")
WORDS = 16             # stamp words a block: start, end, total, then the kinds
ROWS = 1 << 14         # blocks a launch may stamp
STATEMENT = re.compile(r"^(if constexpr \(.*?\) |for \(.*?\) )?(\w+)\s*(<[^;]*?>)?\(")
HELPERS = """
static __device__ unsigned long long g_stamp[%d];
__device__ __forceinline__ unsigned long long* stamp_row() {
  return g_stamp + (blockIdx.y * gridDim.x + blockIdx.x) * %d;
}
__device__ __forceinline__ void stamp_add(int k, unsigned long long t0) {
  if (threadIdx.x == 0) stamp_row()[3 + k] += globaltimer() - t0;
}
""" % (ROWS * WORDS, WORDS)
READER = """
extern "C" int tdt_stamps_{tag}(unsigned long long* host, int n) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, tdt::dl::g_stamp, n * 8));
}}
extern "C" int tdt_stamps_clear_{tag}() {{
  static unsigned long long zeros[{size}];
  return static_cast<int>(cudaMemcpyToSymbol(tdt::dl::g_stamp, zeros, sizeof(zeros)));
}}
"""


def body(src: str, name: str):
    """(start, end) of the body of function ``name``'s definition in
    ``src`` (the text between its braces), or None."""
    for m in re.finditer(r"\b%s\s*\(" % name, src):
        i, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        j = i
        while src[j] in " \n":
            j += 1
        if src[j] != "{":
            continue   # a call, not the definition
        k, depth = j + 1, 1
        while depth:
            depth += {"{": 1, "}": -1}.get(src[k], 0)
            k += 1
        return j + 1, k - 1
    return None


def stamp_statements(text: str) -> tuple[str, int]:
    """Wrap every one-line statement of ``text`` whose callee is a LEAF in a
    timer of its kind; returns the new text and the statements wrapped."""
    lines, wrapped = [], 0
    for line in text.split("\n"):
        code = line.split("//")[0].rstrip()
        m = STATEMENT.match(code.strip())
        if m and m.group(2) in LEAVES:
            if not code.endswith(";") or code.count("(") != code.count(")"):
                raise SystemExit(f"a stamped statement spans lines: {line!r}")
            k = KINDS.index(LEAVES[m.group(2)])
            indent = code[:len(code) - len(code.lstrip())]
            line = (f"{indent}{{ const unsigned long long t_stamp = globaltimer(); "
                    f"{code.strip()} stamp_add({k}, t_stamp); }}")
            wrapped += 1
        lines.append(line)
    return "\n".join(lines), wrapped


def patch(src_pkg: Path, dst: Path, barrier: bool) -> None:
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src_pkg, dst / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    csrc = dst / PKG / "csrc"
    for f in csrc.glob("*.cu"):
        if f.name not in KEEP:
            f.unlink()
    dl = csrc / "dl.cuh"
    s = dl.read_text()
    anchor = s.index("\n", s.index("__device__ __forceinline__ unsigned long long globaltimer()"))
    anchor = s.index("\n}\n", anchor) + 3
    dl.write_text(s[:anchor] + HELPERS + s[anchor:])
    for name, funcs in FUNCS.items():
        f = csrc / name
        s = f.read_text()
        if barrier:   # the device-scope forms with the entry barrier put back
            cond = {"all_to_all.cu": "if constexpr (S == kSys) collective_prologue<S>(c, false);",
                    "ring.cuh": "if constexpr (S == kSys) barrier_all<S>(c);"}.get(name)
            if cond:
                if cond not in s:
                    raise SystemExit(f"{name}: no system-scope-only barrier to put back")
                s = s.replace(cond, cond.split(") ", 1)[1])
        total = 0
        for fn, kernel in funcs:
            span = body(s, fn)
            if span is None:
                continue
            a, b = span
            inner, n = stamp_statements(s[a:b])
            total += n
            if kernel:
                inner = ("\n  if (threadIdx.x == 0) stamp_row()[0] = globaltimer();" + inner +
                         "  if (threadIdx.x == 0) {\n    stamp_row()[1] = globaltimer();\n"
                         "    stamp_row()[2] += stamp_row()[1] - stamp_row()[0];\n  }\n")
            s = s[:a] + inner + s[b:]
        if not total:
            raise SystemExit(f"{name}: no statement left to stamp in {[f for f, _ in funcs]}")
        if name in KEEP:
            s += READER.format(tag=name.split(".")[0], size=ROWS * WORDS)
        f.write_text(s)
    b = dst / PKG / "core" / "build.py"
    s = b.read_text()
    old = "        fn = getattr(lib, name)\n"
    assert old in s, "core/build.py changed: update the patch"
    b.write_text(s.replace(old, "        fn = getattr(lib, name, None)\n"
                                "        if fn is None:\n            continue\n"))


# ---------------------------------------------------------------------------
# the child: one variant's measurements


def measure(variant: str) -> None:
    import ctypes
    import inspect

    sys.path.insert(0, str(OUT / variant))
    import torch

    import triton_distributed_tpu_torch as tt
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm import all_to_all as A
    from triton_distributed_tpu_torch.comm import allreduce as AR
    from triton_distributed_tpu_torch.core import build
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.lang.primitives import Team

    assert tt.__file__.startswith(str(OUT / variant)), tt.__file__
    lib = build.library()
    for tag in ("all_to_all", "collectives"):
        getattr(lib, f"tdt_stamps_{tag}").argtypes = [ctypes.c_void_p, ctypes.c_int]
    scoped = "system_scope" in inspect.signature(A._push).parameters

    def stamps(tag):
        buf = (ctypes.c_ulonglong * (ROWS * WORDS))()
        assert getattr(lib, f"tdt_stamps_{tag}")(ctypes.addressof(buf), ROWS * WORDS) == 0
        return [buf[r * WORDS:(r + 1) * WORDS] for r in range(ROWS) if buf[r * WORDS]]

    def report(name, tag, fn, plain, same, reps=20):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        if not same(got, want):
            raise SystemExit(f"{variant} {name}: the kernel differs from its plain version")
        _, ms = perf_func(fn, iters=20)
        for t in ("all_to_all", "collectives"):
            assert getattr(lib, f"tdt_stamps_clear_{t}")() == 0
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        rows = stamps(tag)
        t0 = min(r[0] for r in rows)
        out = {"variant": variant, "form": name, "ms": ms, "blocks": len(rows),
               "span_us": (max(r[1] for r in rows) - t0) / 1e3,
               "block_start_spread_us": (max(r[0] for r in rows) - t0) / 1e3,
               "block_total_us": {"mean": sum(r[2] for r in rows) / len(rows) / reps / 1e3,
                                  "max": max(r[2] for r in rows) / reps / 1e3}}
        for k, kind in enumerate(KINDS):
            v = [r[3 + k] / reps / 1e3 for r in rows]
            if any(v):
                out[kind] = {"mean": sum(v) / len(v), "max": max(v)}
        print(json.dumps(out), flush=True)

    n, t, h, e = 4, 8192, 2048, 128
    mesh = make_mesh({"tp": n})
    team = Team.of(mesh, "tp")
    g = torch.Generator().manual_seed(0)
    splits = torch.stack([torch.bincount(torch.randint(0, e, (t,), generator=g), minlength=e)
                          for _ in range(n)]).to(torch.int32).cuda()
    meta = A._meta(splits, team, mesh)
    cfg = A.AllToAllConfig()
    chunk, z = A.zone_geometry(t, cfg)
    sent = splits.reshape(n, n, -1).sum(-1).cpu()
    zone_offs = (torch.arange(n, dtype=torch.int32, device="cuda") * z).expand(n, n).contiguous()
    cg = torch.Generator(device="cuda").manual_seed(1)
    rows = {"bf16": torch.randn((n, t, h), generator=cg, device="cuda").to(torch.bfloat16),
            "u8": torch.randint(0, 256, (n, t, h + 128), generator=cg, device="cuda",
                                dtype=torch.uint8)}

    def valid(got, want, to):
        return all(torch.equal(got[r, q, :int(to[q, r])], want[r, q, :int(to[q, r])])
                   for r in range(n) for q in range(n))

    for system in ((False, True) if scoped else (False,)):
        kw = {"system_scope": True} if system else {}
        suffix = ", system scope" if system else ""
        for wire, xs in rows.items():
            w = xs.shape[-1]
            recv = torch.empty((n, n, z, w), dtype=xs.dtype, device="cuda")
            back = torch.empty_like(recv)
            ys = torch.zeros_like(recv)
            A._push("dispatch", xs, ys, meta.send, meta.offs, meta.expected, team, mesh, chunk,
                    z, cfg, True, -1)   # the plain zones, combine's input

            def push(role, src, dst, send, offs, exp, plain, kw=kw):
                A._push(role, src.reshape(n, -1, src.shape[-1]), dst, send, offs, exp, team,
                        mesh, chunk, z, cfg, plain, -1, **kw)
                return dst

            report(f"K17 dispatch {wire}{suffix}", "all_to_all",
                   lambda xs=xs, recv=recv: push("dispatch", xs, recv, meta.send, meta.offs,
                                                 meta.expected, False),
                   lambda xs=xs, recv=recv: push("dispatch", xs, torch.zeros_like(recv),
                                                 meta.send, meta.offs, meta.expected, True),
                   lambda a, b: valid(a, b, sent))
            report(f"K17 combine {wire}{suffix}", "all_to_all",
                   lambda ys=ys, back=back: push("combine", ys, back, meta.expected, zone_offs,
                                                 meta.send, False),
                   lambda ys=ys, back=back: push("combine", ys, torch.zeros_like(back),
                                                 meta.expected, zone_offs, meta.send, True),
                   lambda a, b: valid(a, b, sent.T))
            if system:
                break   # the system-scope form at one shape
        x = torch.randn((n, 4, 4096), generator=cg, device="cuda").to(torch.bfloat16)
        one = comm.AllReduceMethod.ONE_SHOT
        report(f"K11 one-shot 4x4096 bf16{suffix}", "collectives",
               lambda x=x, kw=kw: AR._all_reduce(x, mesh, "tp", one, torch.bfloat16, **kw),
               lambda x=x: comm.all_reduce_ref(x, mesh, "tp", one, torch.bfloat16), torch.equal)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, help="a checkout whose kernels to stamp as 'parent'")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    variants = {"tree": (ROOT / PKG, False), "barrier": (ROOT / PKG, True)}
    if args.tree:
        variants["parent"] = (args.tree.resolve() / PKG, False)
    for v, (src, barrier) in variants.items():
        patch(src, OUT / v, barrier)
    builds = [subprocess.Popen([sys.executable, "-c", "from triton_distributed_tpu_torch.core "
                                "import build; build.build()"], cwd=OUT / v)
              for v in variants]
    if any(p.wait() for p in builds):
        return 1
    for v in variants:
        res = subprocess.run([sys.executable, __file__, "--measure", v])
        if res.returncode:
            return res.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
