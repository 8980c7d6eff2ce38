"""Where K12's and K13's tile time goes, on the card: %globaltimer stamps.

    python3 scripts/torch_overlap_stamps.py      # one Hopper card

Copies triton_distributed_tpu_torch to build/stamps/ (git-ignored), adds
stamps to that copy of csrc/overlap_gemm.cu (thread 0 of each block: before
and after each phase of each of its tiles; K12's copy warps: before and
after each arrival wait), builds it there and prints one JSON line per
kernel at Qwen3-8B tp = 4, B = 4 x 1024, bf16: K13 at o and down (phases
receive, mma, epilogue), K12 at qkv and gate_up (mma, store; arrivals of
lane 0 of each rank), and the main loop alone (mma, store) over the
chain's rank-stacked product and at 4096^3.  Times are in microseconds
from the launch's first block.  The tree's own kernels are untouched; the
patch matches their source text and fails loudly when it has changed.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

root = Path(__file__).resolve().parents[1]
here = root / "build" / "stamps"
src = root / "triton_distributed_tpu_torch"
dst = here / "triton_distributed_tpu_torch"
if dst.exists():
    shutil.rmtree(dst)
shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
p = dst / "csrc" / "overlap_gemm.cu"
s = p.read_text()
S = "__device__ unsigned long long g_stamp[1 << 16];\n"
s = s.replace("namespace tdt {\nnamespace dl {\n", "namespace tdt {\nnamespace dl {\n" + S, 1)
STAMP = ("if (threadIdx.x == 0 && j < 17) g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 80 + 1 "
         "+ 4 * j + {k}] = globaltimer();")
T0 = "if (threadIdx.x == 0) g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 80] = globaltimer(); int j = 0;"
old_rs = """      float d[wg::kAccRegs];
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int s = i / tl.count, t = i % tl.count;
        const WgFrag f(d);
        Partial<OT, WgFrag> part;
        rs_receive<OT>(c, g, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
        wg::mma_tile(wg::stages(dyn), bars, ring, ktiles, d);
        rs_epilogue<OT>(c, g, bars, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
      }"""
new_rs = f"""      float d[wg::kAccRegs];
      {T0}
      for (int i = blockIdx.x; i < total; i += gridDim.x) {{
        const int s = i / tl.count, t = i % tl.count;
        const WgFrag f(d);
        Partial<OT, WgFrag> part;
        {STAMP.format(k=0)}
        rs_receive<OT>(c, g, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
        {STAMP.format(k=1)}
        wg::mma_tile(wg::stages(dyn), bars, ring, ktiles, d);
        {STAMP.format(k=2)}
        rs_epilogue<OT>(c, g, bars, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
        {STAMP.format(k=3)}
        ++j;
      }}"""
assert old_rs in s
s = s.replace(old_rs, new_rs)
old_ag = """      float d[wg::kAccRegs];
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int t = i % tl.count, r = ag_chunk<BIDIR>(c.me, n, i / tl.count);
        wg::mma_tile(st, bars, ring, ktiles, d);
        store_tile<OT>(WgFrag(d), C + r * chunk_c, g.m_loc, g.n_cols, tl.m0(t), tl.n0(t));
      }"""
new_ag = f"""      float d[wg::kAccRegs];
      {T0}
      for (int i = blockIdx.x; i < total; i += gridDim.x) {{
        const int t = i % tl.count, r = ag_chunk<BIDIR>(c.me, n, i / tl.count);
        {STAMP.format(k=0)}
        wg::mma_tile(st, bars, ring, ktiles, d);
        {STAMP.format(k=1)}
        store_tile<OT>(WgFrag(d), C + r * chunk_c, g.m_loc, g.n_cols, tl.m0(t), tl.n0(t));
        {STAMP.format(k=2)}
        ++j;
      }}"""
assert old_ag in s
s = s.replace(old_ag, new_ag)
old_pr = """      float d[wg::kAccRegs];
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int r = i / tl.count, t = i % tl.count;
        wg::mma_tile(wg::stages(dyn), bars, ring, ktiles, d);
        store_tile<OT>(WgFrag(d), Y + r * mn, p.M, p.N, tl.m0(t), tl.n0(t));
      }"""
new_pr = f"""      float d[wg::kAccRegs];
      {T0}
      for (int i = blockIdx.x; i < total; i += gridDim.x) {{
        const int r = i / tl.count, t = i % tl.count;
        {STAMP.format(k=0)}
        wg::mma_tile(wg::stages(dyn), bars, ring, ktiles, d);
        {STAMP.format(k=1)}
        store_tile<OT>(WgFrag(d), Y + r * mn, p.M, p.N, tl.m0(t), tl.n0(t));
        {STAMP.format(k=2)}
        ++j;
      }}"""
assert old_pr in s
s = s.replace(old_pr, new_pr)
# the copy warps of K12: stamp each arrival (slots 70..79 of the block)
old_ar = """  auto arrive = [&](int r) {  // chunk r is here: ready[r] on this rank
    if (tid == 0) {
      wait_flag(c, c.flag(c.me, kRecv + r), kRecv + r, 1, true);"""
new_ar = """  int na = 0;
  auto arrive = [&](int r) {  // chunk r is here: ready[r] on this rank
    if (tid == 0) {
      g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 80 + 70 + 2 * na] = globaltimer();
      wait_flag(c, c.flag(c.me, kRecv + r), kRecv + r, 1, true);
      g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 80 + 71 + 2 * na] = globaltimer();
      ++na;"""
assert old_ar in s
s = s.replace(old_ar, new_ar)
s += """
extern "C" int tdt_stamps(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, tdt::dl::g_stamp, n * 8));
}
extern "C" int tdt_stamps_clear() {
  static unsigned long long zeros[1 << 16];
  return static_cast<int>(cudaMemcpyToSymbol(tdt::dl::g_stamp, zeros, sizeof(zeros)));
}
"""
p.write_text(s)
b = (dst / "core" / "build.py").read_text()
b = b.replace('    "tdt_overlap_probe":', '    "tdt_stamps": [_P, _I],\n    "tdt_stamps_clear": [],\n    "tdt_overlap_probe":')
(dst / "core" / "build.py").write_text(b)

sys.path.insert(0, str(here))
import ctypes  # noqa: E402

import torch  # noqa: E402

import triton_distributed_tpu_torch as tt  # noqa: E402
from triton_distributed_tpu_torch.comm.launch import loop_product  # noqa: E402
from triton_distributed_tpu_torch.core import build  # noqa: E402
from triton_distributed_tpu_torch.core.mesh import make_mesh  # noqa: E402
from triton_distributed_tpu_torch.ops import ag_gemm as AG  # noqa: E402
from triton_distributed_tpu_torch.ops import gemm_rs as RS  # noqa: E402

assert tt.__file__.startswith(str(here)), tt.__file__
lib = build.library()
gen = torch.Generator(device="cuda").manual_seed(0)


def rnd(*shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def stamps(blocks):
    buf = (ctypes.c_ulonglong * (1 << 16))()
    assert lib.tdt_stamps(buf, 1 << 16) == 0
    return [list(buf[b * 80:(b + 1) * 80]) for b in range(blocks)]


def report(name, fn, blocks, events):
    fn()
    torch.cuda.synchronize()
    lib.tdt_stamps_clear()
    fn()
    torch.cuda.synchronize()
    st = stamps(blocks)
    t0 = min(x[0] for x in st if x[0])
    phases = {e: [] for e in events}
    ends = []
    arr = []
    for x in st:
        for j in range(17):
            base = 1 + 4 * j
            if not x[base]:
                break
            for k in range(1, len(events) + 1):
                phases[events[k - 1]].append((x[base + k] - x[base + k - 1]) / 1e3)
            ends.append((x[base + len(events)] - t0) / 1e3)
        arr.append([(x[70 + i] - t0) / 1e3 if x[70 + i] else None for i in range(6)])
    starts = sorted((x[0] - t0) / 1e3 for x in st if x[0])
    out = {"name": name, "kernel_us": max(ends), "block_start_us_max": starts[-1],
           "tiles": len(phases[events[0]])}
    for e, v in phases.items():
        v = sorted(v)
        out[e] = {"mean": sum(v) / len(v), "p50": v[len(v) // 2], "max": v[-1],
                  "sum_per_block": sum(v) / blocks}
    if any(a[0] is not None for a in arr):
        out["copy_arrivals_us(wait start, end) lane0 of each rank"] = [arr[r * (blocks // 4)] for r in range(4)]
    print(json.dumps(out), flush=True)


n = 4
mesh = make_mesh({"tp": n})
a, b = rnd(n, 4096, 1024), rnd(n, 1024, 4096, scale=1024 ** -0.5)
lanes = 33
report("K13 o", lambda: RS.gemm_rs(a, b, mesh), n * lanes, ["receive", "mma", "epilogue"])
report("loop R=4 4096x1024x4096 (the chain's product)", lambda: loop_product(a, b), 132,
       ["mma", "store"])
a, b = rnd(n, 4096, 3072), rnd(n, 3072, 4096, scale=3072 ** -0.5)
report("K13 down", lambda: RS.gemm_rs(a, b, mesh), n * lanes, ["receive", "mma", "epilogue"])
x, w = rnd(n, 1024, 4096), rnd(n, 4096, 1536, scale=4096 ** -0.5)
report("K12 qkv", lambda: AG.ag_gemm(x, w, mesh), n * lanes, ["mma", "store"])
x, w = rnd(n, 1024, 4096), rnd(n, 4096, 6144, scale=4096 ** -0.5)
report("K12 gate_up", lambda: AG.ag_gemm(x, w, mesh), n * lanes, ["mma", "store"])
a, b = rnd(1, 4096, 4096), rnd(1, 4096, 4096, scale=4096 ** -0.5)
report("loop R=1 4096^3", lambda: loop_product(a, b), 132, ["mma", "store"])
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
