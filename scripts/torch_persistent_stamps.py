"""Where K16 spends its time: %globaltimer stamps of its stages and barriers.

    python3 scripts/torch_persistent_stamps.py [--forms ring,stream] [--steps 4,36]   # one H100

Builds K16's sources (and ``collectives.cu``, which they link against) with
``-DTDT_PERSISTENT_STAMPS`` into a library of its own under
``build/stamps_persistent/`` (git-ignored); the served build has no stamps.
Thread 0 of each of rank 0's lanes then stamps every stage's entry and exit
and every rank-wide barrier's release (``csrc/stamps.cuh``), a row of marks
a layer.  The kernel runs at Qwen3-8B's widths (B = 4, position 1056 of
2048, pages of 64, bf16, seeded random weights) for a 4-layer and the
36-layer step at n = 1 and n = 4, in each form asked for: ``ring`` (the
body of PRs 7-14, which the f32 and D = 64 forms keep) and ``stream`` (the
served bf16 D = 128 form).  It prints one JSON line per (form, n, layers):
the event-timed ms of a step, the stamped span, and per stage the median and
worst lane's time summed over the layers (and the six slowest lanes), the
median lane's wait at the barrier after it, and the stage's share of the
span (median lane, stage and wait).  Times are in microseconds unless named ms.
"""
import argparse
import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

root = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(root))

import torch  # noqa: E402

import triton_distributed_tpu_torch as tt  # noqa: E402
from triton_distributed_tpu_torch.core import build  # noqa: E402
from triton_distributed_tpu_torch.core.utils import perf_func  # noqa: E402
from triton_distributed_tpu_torch.ops import persistent_decode as PD  # noqa: E402

SOURCES = ("collectives.cu", "persistent_decode.cu", "persistent_decode_f32.cu",
           "persistent_decode_v2.cu")
# (marks a layer, stages as (name, entry mark, exit mark, release mark of the
# barrier after it, or None)): the TDT_STAMP calls of each form's body
FORMS = {
    "ring": ("tdt_persistent_stamps", 21, [
        ("rms1", 0, 1, 2), ("qkv_partials", 2, 3, 4), ("qkv_finalize", 4, 5, 6),
        ("attn_splits", 6, 7, 8), ("attn_combine", 8, 9, 10), ("o_allreduce", 10, 11, 12),
        ("rms2", 12, 13, 14), ("gate_up", 14, 15, 16), ("swiglu", 16, 17, 18),
        ("down_allreduce", 18, 19, 20)]),
    "stream": ("tdt_persistent_v2_stamps", 20, [
        ("qkv_norm_stage", 0, 1, None), ("qkv_stream", 1, 2, None), ("qkv_tail", 2, 3, None),
        ("attn_wait", 3, 4, None), ("attn_splits", 4, 5, None), ("attn_fold", 5, 6, 7),
        ("o_stage", 7, 8, None), ("o_stream", 8, 9, None), ("o_tail", 9, 10, 11),
        ("gate_up_norm_stage", 11, 12, None), ("gate_up_stream", 12, 13, None),
        ("gate_up_tail", 13, 14, 15), ("down_stage", 15, 16, None),
        ("down_stream", 16, 17, None), ("down_tail", 17, 18, 19)]),
}


def start_build(out: Path, csrc: Path, sources) -> list:
    """Start one nvcc a source (stamps on) into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = []
    for src in (csrc / s for s in sources if (csrc / s).exists()):
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *build.NVCC_FLAGS, "-DTDT_PERSISTENT_STAMPS", "-c", str(src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    return procs


def finish_build(out: Path, procs: list) -> ctypes.CDLL:
    """Wait for the objects, link them and load the library."""
    for obj, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {obj}:\n{text}")
        for ln in text.splitlines():
            if "spill" in ln and "stream_decode" in text:
                print(json.dumps({"build": str(out.name), "ptxas": ln.strip()}), flush=True)
                break
    lib_path = out / "libtdt_stamps.so"
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, "-shared", "-o", str(lib_path),
                    *(str(o) for o, _ in procs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for setter, _, _ in FORMS.values():
        fn = getattr(lib, setter, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
    return lib


def median(v):
    v = sorted(v)
    return v[len(v) // 2]


def run(lib, form: str, n: int, layers: int, B: int = 4, pos: int = 1056) -> dict:
    setter, marks, stages = FORMS[form]
    c = dataclasses.replace(tt.QWEN3_8B, num_layers=layers, max_length=2048)
    dev = torch.device("cuda")
    mesh = tt.make_mesh({"tp": n}) if n > 1 else None
    gen = torch.Generator(device=dev).manual_seed(7)
    model = tt.Qwen3(c, mesh=mesh, device=None if mesh else dev)
    params = model.init(gen, scale=c.hidden ** -0.5)
    cache = tt.init_paged_cache(layers, B, c.num_kv_heads, c.max_length, c.head_dim, c.dtype,
                                page_size=64, device=dev, tp=n,
                                generator=torch.Generator().manual_seed(3))
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    cache.seq_lens.fill_(pos)
    sp = PD.stack_decode_params(params)
    x = params.embed[torch.randint(0, c.vocab, (B,), generator=gen, device=dev)]
    kw = dict(rope_theta=c.rope_theta, rms_eps=c.rms_eps, qk_eps=c.rms_eps,
              sm_scale=c.head_dim ** -0.5, soft_cap=0.0)
    m = mesh or PD._one_rank_mesh(dev)

    def step():
        return PD._launch(x, sp, cache.k, cache.v, cache.block_table, cache.seq_lens, m, "tp",
                          form=form, **kw)

    lanes = PD.form_lanes(form, x.dtype, c.head_dim, c.num_heads // c.num_kv_heads, n)
    buf = torch.zeros(layers * marks * lanes, dtype=torch.int64, device=dev)
    build.check(getattr(lib, setter)(0, marks), setter)
    _, ms = perf_func(step, iters=5, warmup_iters=1)
    build.check(getattr(lib, setter)(buf.data_ptr(), marks), setter)
    step()
    torch.cuda.synchronize()
    build.check(getattr(lib, setter)(0, marks), setter)
    st = buf.view(layers, marks, lanes).double().cpu() / 1e3     # us
    t0 = st[0, 0].min().item()
    span = st[-1, marks - 1].max().item() - t0 if stages[-1][3] is not None else \
        st[-1, stages[-1][2]].max().item() - t0
    out = {"form": form, "n": n, "layers": layers, "lanes": lanes, "ms": ms, "span_us": span,
           "card": torch.cuda.get_device_name(0), "stages": {}}
    for name, a, b, r in stages:
        busy = (st[:, b] - st[:, a]).sum(0)                # per lane, over the layers
        wait = (st[:, r] - st[:, b]).sum(0) if r is not None else torch.zeros_like(busy)
        mb, mw = median(busy.tolist()), median(wait.tolist())
        worst = sorted(range(lanes), key=lambda ln: -busy[ln].item())[:6]
        out["stages"][name] = {"median_us": mb, "worst_us": max(busy.tolist()),
                               "barrier_wait_median_us": mw,
                               "share": (mb + mw) / span if span > 0 else None,
                               "worst_lanes": {ln: round(busy[ln].item(), 1) for ln in worst}}
    del model, params, cache, sp, buf
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--forms", default="ring,stream")
    ap.add_argument("--steps", default="4,36", help="layers of the steps stamped")
    ap.add_argument("--ranks", default="1,4")
    ap.add_argument("--variants", help="a JSON file of {name: {old text: new text}}: also "
                    "stamp the served form built from a copy of persistent_decode_v2.cuh with "
                    "each set of replacements (the first step and rank count only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    base = root / "build" / "stamps_persistent"
    builds = [("tree", base, start_build(base, build.CSRC, SOURCES))]
    for name, reps in (json.loads(Path(args.variants).read_text()) if args.variants
                       else {}).items():
        out = base / f"variant_{name}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out / "csrc")
        hdr = out / "csrc" / "persistent_decode_v2.cuh"
        text = hdr.read_text()
        for old, new in reps.items():
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old[:60]!r} is not in the source once")
            text = text.replace(old, new)
        hdr.write_text(text)
        builds.append((name, out, start_build(out, out / "csrc",
                                              ("collectives.cu", "persistent_decode_v2.cu"))))
    libs = [(name, finish_build(out, procs)) for name, out, procs in builds]
    lib = libs[0][1]
    build.library = lambda: lib          # every launch below goes through the stamped build
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}), flush=True)
    for form in args.forms.split(","):
        if getattr(lib, FORMS[form][0], None) is None:
            print(json.dumps({"form": form, "skipped": "not in this tree"}), flush=True)
            continue
        for layers in (int(v) for v in args.steps.split(",")):
            for n in (int(v) for v in args.ranks.split(",")):
                print(json.dumps(run(lib, form, n, layers)), flush=True)
    for name, vlib in libs[1:]:
        build.library = lambda vlib=vlib: vlib
        PD._stream_lanes.cache_clear()
        layers, n = int(args.steps.split(",")[0]), int(args.ranks.split(",")[0])
        print(json.dumps({"variant": name, **run(vlib, "stream", n, layers)}), flush=True)


if __name__ == "__main__":
    main()
