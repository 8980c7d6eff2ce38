"""Where K1's time goes on the card: %globaltimer stamps in its wgmma body.

    python3 scripts/torch_attention_stamps.py [--tree DIR]   # one Hopper card

Copies ``csrc/`` (of this checkout, or of the checkout at DIR) to
build/stamps_attn/ (git-ignored), adds stamps to that copy of
``flash_attention.cu`` and builds that file alone into a library of its
own.  Thread 0 of each (persistent) block, lane 0 of the first consumer
warpgroup, stamps each of its units: the start, q landed and scaled, the
main loop done (the last P V included), the output stored; and each kv tile after
the first: the tiles landed, S ready, the softmax done, the tile done (the
previous P V waited for, O rescaled, P packed).  The stamped kernel runs
at the Qwen3-8B prefill shape (B = 4, S = 1024, 32 q / 8 kv heads, D =
128, causal, bf16) and prints one JSON line: the kernel's span, the first
and last block's end, and the mean time of each unit and tile phase.
Times are in microseconds.  The tree's own kernels are untouched; the patch matches
their source text and fails loudly when it has changed.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

root = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("--tree", default=str(root), help="checkout whose csrc/ is stamped")
args = ap.parse_args()
sys.path.insert(0, str(root))

import torch  # noqa: E402

from triton_distributed_tpu_torch.core import build  # noqa: E402

NU, TILES = 16, 16            # units and kv tiles stamped a block
SLOTS = 1 + 4 * NU + 4 * NU * TILES   # a block's stamps
here = root / "build" / "stamps_attn"
if here.exists():
    shutil.rmtree(here)
shutil.copytree(Path(args.tree) / "triton_distributed_tpu_torch" / "csrc", here)
p = here / "flash_attention.cu"
s = p.read_text()


def patch(old: str, new: str) -> None:
    global s
    assert s.count(old) == 1, f"the source has changed: {old[:60]!r}"
    s = s.replace(old, new)


def stamp(k: str, cond: str = "true") -> str:
    return (f"if (threadIdx.x == 0 && ({cond})) "
            f"g_stamp[static_cast<size_t>(blockIdx.x) * {SLOTS} + ({k})] = dl::globaltimer();")


def unit(k: int) -> str:
    return stamp(f"1 + 4 * nu + {k}", f"nu < {NU}")


def tile(k: int, j: str = "j") -> str:
    return stamp(f"1 + 4 * {NU} + 4 * (nu * {TILES} + {j}) + {k}", f"nu < {NU} && {j} < {TILES}")


patch("namespace fa {\n", "namespace fa {\n"
      f"__device__ unsigned long long g_stamp[{SLOTS} * 1024];\n")
patch("  const int U = units(a), g = a.H / a.Hkv;\n",
      "  const int U = units(a), g = a.H / a.Hkv;\n  " + stamp("0") + "\n")
patch("    wait_full(&bars.qready[slot], (nu >> 1) & 1);  // landed and scaled\n",
      "    " + unit(0) + "\n    wait_full(&bars.qready[slot], (nu >> 1) & 1);\n    " + unit(1) + "\n")
patch("    softmax(0);\n    pack();\n", "    softmax(0);\n    pack();\n    " + tile(3, "0") + "\n")
patch("      wait_full(&bars.vfull[pst], ((i - 1) / STAGES) & 1);\n",
      "      wait_full(&bars.vfull[pst], ((i - 1) / STAGES) & 1);\n      " + tile(0) + "\n")
patch("      wg::wgmma_wait<1>();\n      fence_acc(s);\n",
      "      wg::wgmma_wait<1>();\n      fence_acc(s);\n      " + tile(1) + "\n")
patch("      softmax(j);\n", "      softmax(j);\n      " + tile(2) + "\n")
patch("      pack();\n    }\n    const int last", "      pack();\n      " + tile(3) + "\n    }\n    const int last")
patch("    // o / l (one reciprocal a row)", "    " + unit(2) + "\n    // o / l (one reciprocal a row)")
patch("    kv += n_kt;\n    ++nu;\n", "    __syncwarp();\n    " + unit(3) + "\n    kv += n_kt;\n    ++nu;\n")
s += f"""
extern "C" int tdt_stamps(unsigned long long* host, long long n) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, tdt::fa::g_stamp, n * 8));
}}
"""
p.write_text(s)
lib_path = here / "k1_stamps.so"
res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                      str(p)], capture_output=True, text=True)
if res.returncode:
    sys.exit(res.stdout[-4000:] + res.stderr[-4000:])
lib = ctypes.CDLL(str(lib_path))
fn = lib.tdt_flash_attention
fn.argtypes = build.SIGNATURES["tdt_flash_attention"]
lib.tdt_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]

gen = torch.Generator(device="cuda").manual_seed(0)
b, h, hk, sq, d = 4, 32, 8, 1024, 128
q = torch.randn((b, h, sq, d), generator=gen, device="cuda").bfloat16()
k = torch.randn((b, hk, sq, d), generator=gen, device="cuda").bfloat16()
v = torch.randn((b, hk, sq, d), generator=gen, device="cuda").bfloat16()
o = torch.empty_like(q)


def run():
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hk, sq, sq, d, 1,
             d ** -0.5, 0.0, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


for _ in range(3):
    run()
torch.cuda.synchronize()
blocks = torch.cuda.get_device_properties(0).multi_processor_count
buf = (ctypes.c_ulonglong * (blocks * SLOTS))()
assert lib.tdt_stamps(ctypes.addressof(buf), blocks * SLOTS) == 0
st = [buf[i * SLOTS:(i + 1) * SLOTS] for i in range(blocks)]
t0 = min(x[0] for x in st)
units = {"q_wait": [], "main_loop": [], "epilogue": [], "gap_to_next": []}
phases = {"tiles_landed": [], "s_ready": [], "softmax": [], "pv_wait_rescale_pack": []}
ends, per_block = [], []
for x in st:
    us = [x[1 + 4 * n:5 + 4 * n] for n in range(NU) if x[1 + 4 * n]]
    per_block.append(len(us))
    for n, u in enumerate(us):
        units["q_wait"].append((u[1] - u[0]) / 1e3)
        units["main_loop"].append((u[2] - u[1]) / 1e3)
        units["epilogue"].append((u[3] - u[2]) / 1e3)
        if n + 1 < len(us):
            units["gap_to_next"].append((us[n + 1][0] - u[3]) / 1e3)
        ends.append(u[3])
        base = 1 + 4 * NU + 4 * n * TILES
        for j in range(1, TILES):
            t = x[base + 4 * j:base + 4 * j + 4]
            if not t[0]:
                break
            prev = x[base + 4 * (j - 1) + 3]
            for i, name in enumerate(phases):
                phases[name].append((t[i] - (prev if i == 0 else t[i - 1])) / 1e3)


def mean(v):
    return sum(v) / len(v) if v else None


out = {"kernel_us": (max(ends) - t0) / 1e3, "blocks": blocks,
       "units_a_block": [min(per_block), max(per_block)],
       "block_end_us": [(min(max(u for u in x[4:1 + 4 * NU:4] if u) for x in st) - t0) / 1e3,
                        (max(ends) - t0) / 1e3],
       "unit_phase_us_mean": {n: mean(v) for n, v in units.items()},
       "tiles": len(phases["softmax"]),
       "tile_phase_us_mean": {n: mean(v) for n, v in phases.items()},
       "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()}
print(json.dumps(out), flush=True)
