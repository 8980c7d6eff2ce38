"""Where K2/K3's clustered form spends its time: %globaltimer stamps.

    python3 scripts/torch_decode_stamps.py [--tree DIR] [--variants FILE.json]   # one Hopper card

Copies ``csrc/`` (of this checkout, or of the checkout at DIR) to
build/stamps_decode/ (git-ignored), adds stamps to that copy of
``decode_cluster.cu`` and builds that file alone into libraries of its own:
the stamped kernel; three in which every block returns right after its
first stamp (the floor of a launch of this grid with its cluster and shared
memory, without the cluster, and with 1 KB of shared memory); and one
stamped copy for each variant in ``--variants`` (a JSON file of {name: {old
text: new text}} replacements in the source).  Thread 0 of each block (lane
0 of consumer warp 0) stamps the block's start, its first piece landed (the
first bulk copy's wait), its own pieces done, the wait for every block of
the cluster to have started, its state pushed to the blocks that finalize
it, the cluster barrier after every push, its slice of the output stored,
and each of warp 0's first three pieces landed and done; lane 0 of the
producer warp stamps its first copy issued (the length and the table
read).  The kernel runs at the Qwen3-8B decode shape (B = 4, 32 q / 8 kv
heads, D = 128, length 1056 of 2048, pages of 64 in a shuffled table) over
the contiguous cache, bf16 pages and int8 pages, and prints one JSON line a
(layout, stamped build): ptxas's registers and spilled bytes, the
event-timed ms a call of it and of the empty builds, the span from the
first block's start to the last block's end, the spread of the blocks'
starts, and the mean of each phase.  Times are in microseconds unless
named ms.  The tree's own kernels are untouched; the patch matches their
source text and fails loudly when it has changed.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

root = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("--tree", default=str(root), help="checkout whose csrc/ is stamped")
ap.add_argument("--variants", help="a JSON file of {name: {old text: new text}}: also "
                "stamp a copy of the source with each set of replacements")
args = ap.parse_args()
sys.path.insert(0, str(root))

import torch  # noqa: E402

from triton_distributed_tpu_torch.core import build  # noqa: E402
from triton_distributed_tpu_torch.core.utils import perf_func  # noqa: E402

SLOTS = 14                     # a block's stamps
PHASES = ("first_copy_issued", "first_piece_landed", "own_pieces_done", "cluster_wait",
          "state_pushed", "cluster_barrier", "slice_stored")
here = root / "build" / "stamps_decode"
if here.exists():
    shutil.rmtree(here)
shutil.copytree(Path(args.tree) / "triton_distributed_tpu_torch" / "csrc", here)
p = here / "decode_cluster.cu"
s = p.read_text()


def patch(old: str, new: str) -> None:
    global s
    assert s.count(old) == 1, f"the source has changed: {old[:60]!r}"
    s = s.replace(old, new)


def stamp(k: int, who: str = "threadIdx.x == 0") -> str:
    return (f"if ({who}) g_stamp[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)"
            f" * {SLOTS} + {k}] = dl::globaltimer();")


patch("namespace dc {\n", "namespace dc {\n__device__ unsigned long long g_stamp[%d * 4096];\n"
      % SLOTS)
patch("  const int warp = threadIdx.x >> 5;\n  if (threadIdx.x == kWarps * 32) {",
      "  const int warp = threadIdx.x >> 5;\n  " + stamp(0) + "\n#ifdef DC_EMPTY\n  return;\n"
      "#endif\n  if (threadIdx.x == kWarps * 32) {")
patch("    wg::mbar_expect_tx(&sm.full[st], F::kStageBytes);\n",
      "    if (k == 0) " + stamp(1, "true") + "\n    wg::mbar_expect_tx(&sm.full[st], F::kStageBytes);\n")
patch("    wait_full(&sm.full[st], (k / kStages) & 1);\n",
      "    wait_full(&sm.full[st], (k / kStages) & 1);\n    if (k == 0) " + stamp(2) + "\n"
      "    if (it == 1) " + stamp(8) + "\n    if (it == 2) " + stamp(10) + "\n")
patch("    if (lane == 0) wg::mbar_arrive(&sm.empty[st]);\n",
      "    if (lane == 0) wg::mbar_arrive(&sm.empty[st]);\n    if (it == 0) " + stamp(12) + "\n"
      "    if (it == 1) " + stamp(9) + "\n    if (it == 2) " + stamp(11) + "\n")
patch("    l[e] += __shfl_xor_sync(kFullMask, l[e], 4);\n",
      "    if (e == 0) " + stamp(3) + "\n    l[e] += __shfl_xor_sync(kFullMask, l[e], 4);\n")
patch("  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");  // every block has started\n",
      "  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n  " + stamp(4) + "\n")
patch("        st_remote(remote(&sm.l[src], q), l[e]);\n      }\n  }\n}",
      "        st_remote(remote(&sm.l[src], q), l[e]);\n      }\n  }\n  " + stamp(5) + "\n}")
patch("barrier.cluster.wait.acquire.aligned;\" ::: \"memory\");\n",
      "barrier.cluster.wait.acquire.aligned;\" ::: \"memory\");\n  " + stamp(6) + "\n")
patch("        __float2bfloat16_rn(den > 0.f ? num / den : 0.f);\n  }\n}",
      "        __float2bfloat16_rn(den > 0.f ? num / den : 0.f);\n  }\n  " + stamp(7) + "\n}")
s += """
extern "C" int tdt_stamps(unsigned long long* host, long long n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, tdt::dc::g_stamp, n * 8));
}
extern "C" int tdt_stamps_clear(long long n) {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, tdt::dc::g_stamp);
  return static_cast<int>(cudaMemset(p, 0, n * 8));
}
"""
patch("  cfg.numAttrs = 1;\n", "#ifdef DC_NO_CLUSTER\n  cfg.numAttrs = 0;\n#else\n"
      "  cfg.numAttrs = 1;\n#endif\n")
patch("  cfg.dynamicSmemBytes = smem;\n", "#ifdef DC_SMEM\n  cfg.dynamicSmemBytes = DC_SMEM;\n"
      "#else\n  cfg.dynamicSmemBytes = smem;\n#endif\n")
base = s
# the variants: (label, replacements in the source, nvcc flags); the empty
# ones return after the first stamp: the floor of a launch of the tree's
# grid with its cluster and shared memory, without the cluster, and with 1
# KB of shared memory
VARIANTS = [("stamped", {}, []), ("empty", {}, ["-DDC_EMPTY"]),
            ("empty_no_cluster", {}, ["-DDC_EMPTY", "-DDC_NO_CLUSTER"]),
            ("empty_1kb_smem", {}, ["-DDC_EMPTY", "-DDC_SMEM=1024"])]
if args.variants:
    VARIANTS += [(name, subs, []) for name, subs in
                 json.loads(Path(args.variants).read_text()).items()]
libs, ptxas = {}, {}
for label, subs, extra in VARIANTS:
    s = base
    for old, new in subs.items():
        patch(old, new)
    src = here / f"decode_{label}.cu"
    src.write_text(s)
    lib_path = here / f"decode_{label}.so"
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *extra, "-shared", "-o",
                          str(lib_path), str(src)], capture_output=True, text=True)
    if res.returncode:
        if label == "stamped":
            sys.exit(res.stdout[-4000:] + res.stderr[-4000:])
        print(json.dumps({"variant": label, "build_error": res.stderr[-1500:]}), flush=True)
        continue
    # ptxas -v: each instantiation's registers and spilled bytes
    regs, spill, entry = {}, {}, ""
    for ln in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln and "decode_cluster" in entry:
            spill[entry] = sum(int(w) for w in re.findall(r"(\d+) bytes spill", ln))
        elif "Used " in ln and "decode_cluster" in entry:
            regs[entry] = int(ln.split("Used ")[1].split()[0])
    ptxas[label] = {"registers": sorted(set(regs.values())),
                    "spilled_bytes_max": max(spill.values(), default=0)}
    lib = ctypes.CDLL(str(lib_path))
    lib.tdt_decode_cluster.argtypes = build.SIGNATURES["tdt_decode_cluster"]
    lib.tdt_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.tdt_stamps_clear.argtypes = [ctypes.c_longlong]
    libs[label] = lib

gen = torch.Generator(device="cuda").manual_seed(0)
B, H, HKV, D, CAP, POS, PS = 4, 32, 8, 128, 2048, 1056, 64
MP = CAP // PS
q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
kc = torch.randn((B, HKV, CAP, D), generator=gen, device="cuda").bfloat16()
vc = torch.randn((B, HKV, CAP, D), generator=gen, device="cuda").bfloat16()
pk = torch.randn((B * MP, HKV, PS, D), generator=gen, device="cuda").bfloat16()
pv = torch.randn((B * MP, HKV, PS, D), generator=gen, device="cuda").bfloat16()
ik = torch.randint(-127, 128, (B * MP, HKV, PS, D), generator=gen, device="cuda").to(torch.int8)
iv = torch.randint(-127, 128, (B * MP, HKV, PS, D), generator=gen, device="cuda").to(torch.int8)
ks = torch.rand((B * MP, HKV), generator=gen, device="cuda") * 0.02 + 0.005
vs = torch.rand((B * MP, HKV), generator=gen, device="cuda") * 0.02 + 0.005
table = torch.randperm(B * MP, generator=torch.Generator().manual_seed(0)).to(torch.int32) \
    .reshape(B, MP).cuda()
lens = torch.full((B,), POS, dtype=torch.int32, device="cuda")
out = torch.empty_like(q)
LAYOUTS = {"contiguous": (kc, vc, None, None, None, 0, 0),
           "paged": (pk, pv, table, None, None, PS, MP),
           "int8": (ik, iv, table, ks, vs, PS, MP)}


def call(lib, layout):
    k, v, tab, kscale, vscale, ps, mp = LAYOUTS[layout]
    err = lib.tdt_decode_cluster(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), 1, 0,
        None if tab is None else tab.data_ptr(), None if kscale is None else kscale.data_ptr(),
        None if vscale is None else vscale.data_ptr(), out.data_ptr(), B, H, HKV,
        CAP, ps, mp, k.shape[0] if tab is not None else 0, D ** -0.5, 0.0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


def mean(v):
    return sum(v) / len(v) if v else None


card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
for layout, (label, lib) in ((x, y) for x in LAYOUTS for y in libs.items()):
    if label.startswith("empty"):
        continue
    row = {"layout": layout, "variant": label, "card": card, "ptxas": ptxas[label]}
    for other, olib in libs.items():
        if other == label or other.startswith("empty"):
            _, row[f"{other}_ms"] = perf_func(lambda: call(olib, layout), iters=50)
    blocks = 16 * B * HKV
    assert lib.tdt_stamps_clear(blocks * SLOTS) == 0
    call(lib, layout)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (blocks * SLOTS))()
    assert lib.tdt_stamps(ctypes.addressof(buf), blocks * SLOTS) == 0
    st = [x for x in (buf[i * SLOTS:(i + 1) * SLOTS] for i in range(blocks)) if x[0]]
    row["blocks"] = len(st)
    t0 = min(x[0] for x in st)
    row["span_us"] = (max(x[7] for x in st) - t0) / 1e3
    row["block_start_us"] = [(min(x[0] for x in st) - t0) / 1e3,
                             mean([(x[0] - t0) / 1e3 for x in st]),
                             (max(x[0] for x in st) - t0) / 1e3]
    row["block_end_us"] = [(min(x[7] for x in st) - t0) / 1e3, (max(x[7] for x in st) - t0) / 1e3]
    # each phase from the stamp before it (the first copy and the first
    # piece from the block's start); a block whose warp 0 has no piece
    # skips the first piece and its own pieces
    befores = (0, 0, 2, 3, 4, 5, 6)
    row["phase_us_mean"] = {
        name: mean([(x[i] - x[before]) / 1e3 for x in st if x[i] and x[before]])
        for i, (name, before) in enumerate(zip(PHASES, befores), start=1)}
    row["phase_us_mean"]["first_piece_after_copy"] = mean(
        [(x[2] - x[1]) / 1e3 for x in st if x[1] and x[2]])
    # warp 0's pieces: the first one's compute, then each later one's wait
    # for its data (from the end of the one before) and its compute
    row["warp0_piece_us_mean"] = {
        "0_compute": mean([(x[12] - x[2]) / 1e3 for x in st if x[12] and x[2]]),
        "1_wait": mean([(x[8] - x[12]) / 1e3 for x in st if x[8] and x[12]]),
        "1_compute": mean([(x[9] - x[8]) / 1e3 for x in st if x[9] and x[8]]),
        "2_wait": mean([(x[10] - x[9]) / 1e3 for x in st if x[10] and x[9]]),
        "2_compute": mean([(x[11] - x[10]) / 1e3 for x in st if x[11] and x[10]])}
    print(json.dumps(row), flush=True)
