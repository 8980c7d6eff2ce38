#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (triton_distributed_tpu_torch) on one
NVIDIA H100 and check it.

    python3 chip_smoke.py      # needs one Hopper card

Phases, each printing JSON lines; any failure exits non-zero:

1. device   -- CUDA present with capability (9, 0); the card's name and power
               limit as ``nvidia-smi`` prints them.
2. build    -- nvcc builds the kernels from ``triton_distributed_tpu_torch/csrc``;
               the library's SASS must show HGMMA on UTMALDG (TMA) loads in
               every bf16 instantiation of K12, K13, their loop alone, K5's
               prefill form, K1's served form, K8's D = 128 fold, K6 and
               K19's fused and mxu modes, UTMALDG and no HGMMA in K19's dma
               mode (its consumers run no product), and HMMA on UTMALDG loads
               in every instantiation of K2/K3's clustered form; K5's, K1's,
               K8's, K6's, K19's and K2/K3's with no local memory (no
               spill).
3. kernels  -- each kernel against its plain PyTorch version on the card:
               small edge cases (f32 and bf16, GQA 1-8, soft cap, qk-norm on
               and off, ragged and empty rows, a position on a page boundary
               and in the table's last slot, shuffled page tables; for K4 the
               pools after the append as well; for K5 empty experts, one
               expert, a zero tail, T 1/37/1000, K and N off the tile, held
               to BF16_TOL + 2**-7 |plain| in bf16; and K5's slot schedule
               and prefill work units as its blocks derive them, against
               ops/swizzle.py, slot for slot and unit for unit; K2/K3's
               clustered form (bf16, D = 128) at GQA 1, 2 and 8 over the
               contiguous cache, bf16 pages and int8 pages, lengths 0, 1, 63,
               64, 65 and the capacity, soft cap 0 and 5, a (B,), a 0-d
               device and an int length, each result bit for bit unmoved by
               NaN past the lengths), K1,
               K3 and K4 once at the Qwen3-30B-A3B attention shapes, then the
               main-path shapes (Qwen3-8B attention: B = 4, prompt 1024,
               cache of 2048, position 1056; Qwen3-30B-A3B expert products:
               32768 prefill rows, 32 decode rows, splits from a real
               routing; K2 with an int and with a 0-d device length, K3 on
               bf16 pages at the 30B-A3B shape too), each timed with CUDA
               events beside its plain version, its bound, and SDPA, the
               per-kernel chain (K4) or ``torch._grouped_mm`` (K5).
   local_ops -- the local ops beside the serving path (K6-K8).  K6, the
               tiled GEMM, against its plain version at the edges (M 1, 37,
               1000, 4096; N and K 136 and 4104; every built tile; bf16 ->
               bf16 and f32, and f32), bf16 held to BF16_TOL + 2**-7 |plain|
               and shown to reject a k-tile left out and a neighbour's
               n-tile.  Then the path, counted: K6 at each main shape
               (bench.py's 7168^3 and 4096 x 7168 x 7168, Qwen3-8B's prefill
               projections at 4096 rows) with its default tile,
               fresh_tune_matmul at 7168^3 and at gate_up (the crown, every
               candidate's time and the roofline share printed; K6's counter
               must rise by exactly the sweep's K6 calls), K7's states of a
               ragged Qwen3-8B decode over the contiguous cache and over bf16
               and int8 pages of 64, and K8 folding four 1024-key chunks at
               q_offset 3072 (the last rank of a 4-way ring).  Then each
               against its plain version (K7 split by split, empty splits
               exact, merged and normalized against K2; K8's fold against the
               plain fold and its finalized output against K1 over the whole
               4096; outputs held to BF16_TOL rms(row) + 2**-7 |plain|, shown
               to reject a state with one chunk's or split's V from the
               neighbouring kv head and one with a 64-key tile left out),
               timed beside its bound and torch.matmul or SDPA.  K8's edges
               (bf16, D = 128) from a carried state: a chunk wholly in the
               future (the state back bitwise), a partly visible one (delta
               -700), the soft cap on, G = 8, Sq and the chunk off every
               tile; each held to the plain fold, rows with no visible key
               bitwise, int and 0-d device offsets bitwise equal.
   collectives -- K9-K11 (AllGather, ReduceScatter, AllReduce) on ranks
               co-located on the card, one cooperative launch per call:
               every method at n 2, 3, 4, 8, f32 and bf16, shards of 1, 3
               and 17 rows at widths 8, 136, 4104 and 5, held bitwise to the
               plain versions (the schedules walked with PyTorch ops), every
               signal pad back at zero after every call; three interleaved
               repeats; a {"dp": 2, "tp": 4} mesh over either axis.  A child
               process runs a gather in which one rank never credits its
               puts: it must fail by name (rank 0, flag recv[1]) when the
               bounded wait runs out; so must K11's one-shot and K17 in both
               their scopes.  Then the main rows at Qwen3-8B's width
               under tp = 4 (bf16; AG of 1024 x 4096 and 1 x 4096 shards, RS
               of 4096 x 4096 partials, one-shot AR 4 x 4096, two-shot AR
               4096 x 4096), counted, timed beside the HBM bound of all the
               ranks' bytes, the NVLink time four cards would take (not
               measured), the plain version and one PyTorch call; K9 (which
               runs at device scope without an entry barrier) in its
               system-scope form at its main rows' shapes, each form bitwise
               and timed in turns with the device-scope form; K11's
               one-shot in its system-scope form (the multi-card host's) at
               4 x 4096, bitwise, timed in turns with the device-scope form.
   overlap  -- K12-K14 (AllGather-GEMM both rings, GEMM-ReduceScatter,
               GEMM-AllReduce in its ring and its one-shot form) on co-located
               ranks: n 2, 3, 4; f32, bf16 and bf16 -> f32; a rank's product
               of 1, 37 and 130 rows by K 136-1032 by N 136-264, off the tile
               on every edge; each call bitwise equal to its chain (K9 then
               K12/K13's wgmma main loop run alone as a rank-stacked product,
               that loop then K10, K14's ring loop alone (gemm_tile.cuh's
               tiles) then K11's two-shot for its ring; K14's one-shot: the
               slot-order f32 sum of its own rounded partials), within a
               stated limit of its plain version (the schedule walked with
               PyTorch ops; overlap_limit charges each rounding at the size of
               the value rounded), shown to reject a result with one rank's
               partial left out, one chunk taken from another rank (the
               rings) or one slot added twice (the one-shot) by FAULT_MARGIN
               limits; the gathered A bitwise, every pad at rest; interleaved
               repeats.  A child process runs a K12 in which one rank never
               credits its puts: it must fail by name, as the gather's does.
               The wgmma loop alone at the four whole prefill products, timed
               beside torch.matmul and K6 (kernel_main lines, not in the
               kernels line).
               Then the main rows at Qwen3-8B tp = 4 (prefill qkv, gate_up, o,
               down at 4 x 1024 rows; decode o and down at 4 rows, K14's
               one-shot, its ring form timed in turns beside it), timed beside
               the bound (obs/costs.py's operations over all ranks, the
               function's bytes), the plain version, the chain (and K12/K13's
               chain of PRs 6-10 on K6, k6_chain_ms) and one
               torch.matmul of the whole unsharded product.  K15 (phase
               fused_tp, after overlap) likewise: both bodies in both forms at
               the edges, then the main rows (the one-shot, the ring timed in
               turns beside it); a stalled-rank child runs K15's one-shot,
               whose waits are at device scope: it must fail by name too.
4. serve    -- Qwen3-8B at full width and depth with seeded random weights,
               batch 4, max_length 2048: two requests of 1024 prompt tokens and 32
               new tokens in five modes (contiguous, paged, paged + fused,
               paged + int8, paged + int8 + fused); the launch counters must
               rise by 36 per prefill (K1) and by 36 per decode step for the
               mode's decode kernel (K2, K3, K4, K3-int8, K4-int8), and by
               nothing for any other kernel.  Then Qwen3-30B-A3B (full width,
               24 of its 48 layers: MOE_SERVE_LAYERS; 128 experts, top-8; the
               dense model freed first) in two modes (paged, paged + fused):
               K1 +24 and K5 +48 per prefill, the mode's kernel +24 and K5
               +48 per decode step, K5's counted by form as well (+24 each
               for up and down); before it, one
               MoE layer's prefill and decode forward under
               ``torch.cuda.set_sync_debug_mode("error")``.  Then a
               torch.profiler trace of one prefill and eight decode steps
               per mode: wall vs kernel time, idle share, kernel time by
               class (attention, grouped GEMM, overlapped GEMM, collective,
               GEMM, other), the decode kernels' launches by name (a decode
               step must run no combine pass).
   ep_cases -- K17 (the EP all-to-all) on co-located ranks, n 2, 3, 4, 8:
               f32 and bf16 rows of widths 8, 136 and 2048, packed u8 rows of
               H 16, 144 and 2048 (+ 128; 136-byte rows refused),
               37 or 200 rows a rank, uniform and skewed splits (every row to
               one peer, a silent rank, empty experts, short totals), the
               farthest-first emission order, one row a rank and one row to
               each peer (most lanes credit a share of zero rows); dispatch
               and combine held bitwise to the plain versions on the valid
               rows with every landing buffer planted with NaN first, the
               round trip equal to the input, every pad at rest; the
               system-scope form at n = 4 on 8192 bf16 rows of 4096 bytes a
               rank, bitwise, timed in turns with the device-scope form.
               K18 (the wire pack) bitwise against its plain version, fp8
               and int8, f32 and bf16 rows, 1-1000 rows, H 16-4096, with an
               all-zero, an all-negative, a denormal-range row and one
               element at 1e4, decoded within the codec's envelope.  The
               parity-slot AllGather layer (B17 on K9): slots alternate,
               call k intact through call k + 1, memory flat from the second
               call.  The collectives phase's stalled-rank children run K17
               too, both scopes (each must fail by name).
   serve_tp -- Qwen3-8B at tp = 4 on four ranks co-located on the card, full
               width and depth (the tp = 1 engines freed first), batch 4,
               prompts of 1024, 64 new tokens, in contiguous psum and paged
               psum, ar and gemm_ar: per prefill K1 +36, K12 +72, K13 +72; per
               step K2 or K3 +36, K11 +72 (ar), K14 +72 (gemm_ar), nothing
               else; two requests a mode, a profile, peak memory; the tp = 4
               decode step of each mode under the sync check.
   serve_ep -- Qwen3-30B-A3B at tp = 4 under expert parallelism
               (moe_strategy="ep"), full width and 24 layers, from the tp = 1
               draw of the MoE serve (the experts' tensors shared, its engines freed
               first).  First the main rows at its prefill (8192 routed rows a
               rank, splits from a real routing): K17 dispatch and combine on
               bf16 and u8 rows, K18 on the rows it packs on each hop, bitwise,
               timed beside the bound, the plain version and an
               index_select gather; the layer unchanged by NaN in every landing
               buffer, on both wires, held to the tp = 1 layer (the fp8 wire:
               with the codec applied, within one bf16 ulp, a limit the bf16
               wire misses by FAULT_MARGIN).  Then paged
               psum, paged fused and paged fused with moe_fp8_wire, two requests
               each: per prefill K1 +24, K12 +24, K13 +24, K17 +48, K5 +48 (and
               K18 +48 with the fp8 wire), per step K3 or K4 + K15 +24 and K5
               +48, exact and by form; an EP prefill and step under the sync
               check on each wire; a profile per mode; peak memory.
   aot_serving -- tutorial 14's path.  K19 (the overlap probe) against its
               plain versions: fused, dma and mxu at m = n = 1000, k = bk and
               3 bk, bf16 and f32, every built tile (fused and mxu within
               K6's limit, dma within one output ulp and its sum's
               reordering), and an mxu probe reading A's block (0, 1), which
               must miss by FAULT_MARGIN; then the three modes at bench.py's
               4096^3 bf16, timed interleaved (the path, counted), with
               hidden_pct, K6 and torch.matmul beside them, and K12's
               decomposition at tp = 4 (qkv, gate_up: K12 against K9 two-way
               and its own loop alone on the gathered rows).  Then Qwen3-8B on the contiguous
               cache, full width and depth, batch 4, in psum and fused at
               tp = 1 and psum, ar, gemm_ar and fused at tp = 4: eager serves
               of a 1024- and a 700-token prompt, precompile([768, 1024])
               (CUDA graphs), the model's prefill and decode replaced by
               functions that raise, the launch counters frozen, replayed
               serves (twice each) with tokens equal to eager; one replayed
               step from a given cache state within PARITY_TOL of the eager
               step, the prefill at 700 padded to 768 within PAD_PREFILL_TOL
               of eager; replayed and eager serve statistics, a profile of
               8 replayed steps, peak memory.  A second process
               (``--aot-child``) serves the saved manifest through
               load_precompiled, runs no nvcc and returns the parent's tokens;
               manifests of another batch or config are refused by name.
               Last, a calibration in a throwaway TDT_LINKCAL_CACHE flips a
               1 MiB gather from the ring to the push.
5. parity   -- full width at 2 layers in f32, batch 2, prompt 128, 8 new
               tokens: the port on the card (kernels) and on the CPU (plain
               versions) from the same weights give the same logits within
               1e-3 (prefill, and every decode step of the fused, int8 and
               int8 + fused modes, each from one cache state on both sides;
               int8 codes at most one apart, see phase_parity) and the same
               greedy tokens; Qwen3-30B-A3B likewise in the paged and paged +
               fused modes, with the same top-8 experts for every token,
               layer and step.
   parity_tp -- full width at 2 layers in f32, batch 4, prompt 128, 8 new
               tokens: the port at tp = 4 on the card and on the CPU and at
               tp = 1 on the card, from one seed, give prefill logits and every
               decode step's logits within PARITY_TOL and the same greedy
               tokens, in every served tp = 4 mode on both caches.
   parity_ep -- Qwen3-30B-A3B width at 2 layers in f32, batch 2, prompt 128,
               8 new tokens: EP at tp = 4 on the card and on the CPU and tp = 1
               on the card, from one draw: prefill logits and every psum and
               fused decode step within PARITY_TOL, the same greedy tokens and
               the same top-8 experts for every token, layer and step; the fp8
               wire's prefill, card against CPU, within FP8_GAP_SHARE of the
               fp8-vs-bf16 wire gap (which the bf16 wire's logits must miss),
               the same greedy tokens and first-layer experts.
6. the kernels line, the card line, and the result line.

The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import sys
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12     # HBM3
SEED = 0
BATCH, PROMPT, MAX_LEN, GEN, DECODE_POS, PAGE = 4, 1024, 2048, 64, 1056, 64
BF16_TOL = 2e-2   # |kernel - plain|: outputs are O(1); bf16 keeps 8 bits and
                  # p is rounded at different running maxima in the two
F32_TOL = 1e-4    # summation order only
PARITY_TOL = 1e-3
# K5's bf16 results: |kernel - plain| <= BF16_TOL + K5_RTOL |plain|.  The two
# sum in f32 in different orders and round once to bf16, whose ulp at a
# value v is at most 2**-7 |v|: a limit that grows with the output, as no
# absolute one can at outputs of any size.
K5_RTOL = 2.0 ** -7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def bound(flops: float, nbytes: float, flops_rate: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of operations over the peak
    rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / flops_rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------


def phase_build(tt) -> None:
    from triton_distributed_tpu_torch.core import build

    t0 = time.perf_counter()
    path, log = build.build()
    if not log:   # built earlier: the log it saved beside the library
        log = (path.parent / "nvcc.log").read_text()
    lines = [ln.strip() for ln in log.splitlines()]
    # ptxas -v: per kernel instantiation, "Compiling entry function '<name>'",
    # a spill line that should read 0 bytes, and "Used N registers"
    spills, entry, spill = [], "", ""
    per_entry = {}
    for ln in lines:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "bytes spill" in ln:
            spill = ln.split("bytes stack frame, ")[-1]
            if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                spills.append(f"{entry}: {ln}")
        elif "Used " in ln and "registers" in ln:
            per_entry[entry] = f"{ln.split('Used ')[1].split(',')[0]}; {spill}"
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(Path(__file__).resolve().parent)),
          "kernels_compiled": sum("Used" in ln and "registers" in ln for ln in lines),
          "max_registers": max([int(ln.split("Used ")[1].split()[0])
                                for ln in lines if "Used " in ln] or [0]),
          "spilling": spills[:8]})
    # registers and spills of each K4 instantiation and each K3 int8-page
    # instantiation (storage type `signed char`, mangled `a`)
    names = demangle(list(per_entry))
    emit({"phase": "build_new_kernels", "instantiations": [
        f"{names[e]}: {per_entry[e]}" for e in per_entry
        if "fused_attn_decode_kernel" in e or "grouped_gemm" in e or "flash_fwd_wgmma" in e
        or "matmul_wgmma" in e
        or "ag_gemm_kernel" in e or "gemm_rs_kernel" in e or "product_kernel" in e
        or "fused_ar_kernel" in e or "persistent_decode_kernel" in e
        or "stream_decode_kernel" in e or "decode_cluster" in e or "probe_wgmma" in e
        or re.search(r"decode_splitI(f|13__nv_bfloat16)a", e)]})
    stream = [v for e, v in per_entry.items() if "stream_decode_kernel" in e]
    check(len(stream) == 1, f"{len(stream)} instantiations of K16's served form, not 1")
    spilled = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", stream[0])]
    check(len(spilled) == 2 and max(spilled) <= STREAM_SPILL_BYTES,
          f"K16's served form spills more than {STREAM_SPILL_BYTES} bytes: {stream[0]}")
    build.library()
    phase_sass(build, path)


# K16's served form runs two blocks an SM, which caps a thread at 128
# registers: ptxas spills 4 bytes of it (stores and loads each; 112 before
# its attention cell took two rows a step), and no more may spill
STREAM_SPILL_BYTES = 4


# K12's and K13's bf16 kernels (both rings, both output dtypes), their loop
# alone, K5's prefill form (both output dtypes), K1's served form and K8's
# bf16 D = 128 fold (flash_fwd_wgmma<false> and <true>), K6's bf16 form
# (both output dtypes) and K19's fused and mxu modes (probe_wgmma<BN, mode>,
# both tiles): each must issue wgmma (HGMMA) on TMA loads (UTMALDG); the
# last five, redesigned since, must also touch no local memory (no spill:
# LDL / STL)
SASS_KERNELS = {"ag_gemm_kernelI13__nv_bfloat16": 4, "gemm_rs_kernelI13__nv_bfloat16": 2,
                "product_kernelI13__nv_bfloat16": 2, "grouped_gemm_wgmmaI": 2,
                "flash_fwd_wgmma": 2, "matmul_wgmma": 2,
                "probe_wgmmaILi128ELi0E": 1, "probe_wgmmaILi256ELi0E": 1,
                "probe_wgmmaILi128ELi2E": 1, "probe_wgmmaILi256ELi2E": 1}
# K2/K3's clustered form (G 1, 2, 4, 8 over a contiguous cache, bf16 pages
# and int8 pages): mma.sync (HMMA) on TMA loads (UTMALDG)
SASS_MMA_KERNELS = {"decode_cluster": 12}
# K19's dma mode (both tiles): the same TMA loads (UTMALDG) and no product
# (no HGMMA: its consumers only wait on and release the stages)
SASS_TMA_KERNELS = {"probe_wgmmaILi128ELi1E": 1, "probe_wgmmaILi256ELi1E": 1}
NO_LOCAL = ("grouped_gemm_wgmmaI", "flash_fwd_wgmma", "matmul_wgmma", "decode_cluster",
            "probe_wgmma")


def phase_sass(build, lib: Path) -> None:
    """The library's SASS (cuobjdump -sass): every bf16 instantiation of
    K12, K13, their loop alone, K5's prefill form, K1's served form, K8's
    D = 128 fold, K6 and K19's fused and mxu modes runs HGMMA on UTMALDG
    loads, K19's dma mode UTMALDG loads and no HGMMA, K2/K3's clustered form
    HMMA on UTMALDG loads; K5's, K1's, K8's, K6's, K19's and K2/K3's touch
    no local memory."""
    import subprocess

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    check(tool.exists(), f"{tool} not found: the SASS of the wgmma kernels cannot be checked")
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    counts, fn = {}, None
    ops = ("HGMMA", "HMMA", "UTMALDG", "LDL", "STL")
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            fn = name if any(k in name for k in (*SASS_KERNELS, *SASS_MMA_KERNELS,
                                                 *SASS_TMA_KERNELS)) else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn:
            words = set(re.findall(r"\b([A-Z0-9]+)(?:\.[A-Z0-9_.]+)?\b", ln))
            for op in ops:
                counts[fn][op] += op in words
    names = demangle(list(counts))
    emit({"phase": "build_sass", "kernels": {names[f]: c for f, c in counts.items()}})
    for key, want in (*SASS_KERNELS.items(), *SASS_MMA_KERNELS.items(),
                      *SASS_TMA_KERNELS.items()):
        found = [c for f, c in counts.items() if key in f]
        check(len(found) == want, f"{len(found)} instantiations of {key} in the SASS, not {want}")
        if key in SASS_TMA_KERNELS:
            check(all(c["UTMALDG"] and not c["HGMMA"] for c in found),
                  f"an instantiation of {key} issues no UTMALDG, or a product (HGMMA)")
        else:
            mma = "HMMA" if key in SASS_MMA_KERNELS else "HGMMA"
            check(all(c[mma] and c["UTMALDG"] for c in found),
                  f"an instantiation of {key} issues no {mma} or no UTMALDG")
        if any(k in key for k in NO_LOCAL):
            check(all(c["LDL"] + c["STL"] == 0 for c in found),
                  f"an instantiation of {key} touches local memory (spills): {found}")


def demangle(symbols: list[str]) -> dict[str, str]:
    """C++ names of mangled kernel symbols, through the CUDA toolkit's
    cu++filt where it is present (else the symbols as they are)."""
    from triton_distributed_tpu_torch.core import build

    tool = Path(build.find_nvcc()).parent / "cu++filt"
    if not symbols or not tool.exists():
        return {s: s for s in symbols}
    import subprocess

    out = subprocess.run([str(tool), *symbols], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(symbols):
        return {s: s for s in symbols}

    def short(name):   # "decode_split<float, signed char, 128, 4, 1>"
        name = re.sub(r"^void |tdt::<unnamed>::|tdt::\(anonymous namespace\)::|"
                      r"\((int|bool)\)", "", name)
        return name[:name.index(">(") + 1] if ">(" in name else name

    return {s: short(n) for s, n in zip(symbols, out)}


def phase_kernel_cases(tt, torch) -> None:
    """Edge cases at small shapes, both storage types, before the real ones."""
    from triton_distributed_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    results = []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        # D = 128 in bf16 is K1's wgmma body: GQA 1, 3 (a pair with one head),
        # 4 and 8, S = 1 and S off the 64-row q tile and the 128-row kv tile
        for (b, h, hk, s, d, causal, cap) in (
                (2, 4, 2, 200, 64, True, 0.0), (1, 8, 8, 130, 128, False, 0.0),
                (2, 4, 1, 96, 128, True, 30.0), (1, 2, 2, 64, 64, False, 5.0),
                (2, 16, 2, 333, 128, True, 0.0), (1, 16, 2, 1, 128, True, 0.0),
                (1, 6, 2, 200, 128, False, 5.0)):
            q, k, v = rnd(b, h, s, d, dtype=dtype), rnd(b, hk, s, d, dtype=dtype), \
                rnd(b, hk, s, d, dtype=dtype)
            got = A.flash_attention(q, k, v, causal=causal, soft_cap=cap)
            want = A.flash_attention_ref(q, k, v, causal=causal, soft_cap=cap)
            results.append(("flash_attention", str(dtype), (b, h, hk, s, d, causal, cap),
                            (got.float() - want.float()).abs().max().item(), tol))
        b, h, hk, smax, d, ps = 3, 8, 2, 320, 128, 64
        q = rnd(b, h, d, dtype=dtype)
        k, v = rnd(b, hk, smax, d, dtype=dtype), rnd(b, hk, smax, d, dtype=dtype)
        lens = torch.tensor([0, 131, 320], dtype=torch.int32, device=dev)
        for kv_len, cap in ((lens, 0.0), (77, 0.0), (lens, 5.0)):
            got = A.decode_attention(q, k, v, kv_len, soft_cap=cap)
            want = A.decode_attention_ref(q, k, v, kv_len, soft_cap=cap)
            ragged = torch.is_tensor(kv_len)
            check(not (ragged and got[0].any()),
                  "decode_attention: a length-0 row is not zeros")
            results.append(("decode_attention", str(dtype),
                            (b, h, hk, smax, d, lens.tolist() if ragged else kv_len, cap),
                            (got.float() - want.float()).abs().max().item(), tol))
        mp = smax // ps
        pk, pv = rnd(b * mp, hk, ps, d, dtype=dtype), rnd(b * mp, hk, ps, d, dtype=dtype)
        table = torch.randperm(b * mp, generator=torch.Generator().manual_seed(SEED)) \
            .to(torch.int32).reshape(b, mp).to(dev)
        table[1, 3:] = 0          # past seq 1's pages: pointing at page 0, never read
        for cap in (0.0, 5.0):
            got = A.paged_decode_attention(q, pk, pv, table, lens, soft_cap=cap)
            want = A.paged_decode_attention_ref(q, pk, pv, table, lens, soft_cap=cap)
            check(not got[0].any(), "paged_decode_attention: a length-0 row is not zeros")
            results.append(("paged_decode_attention", str(dtype), (b, h, hk, ps, mp, d, cap),
                            (got.float() - want.float()).abs().max().item(), tol))
    # the split + combine pass in bf16 (D = 64), beside the clustered form
    q64, k64, v64 = (rnd(*shape, dtype=torch.bfloat16) for shape in
                     ((3, 8, 64), (3, 2, 200, 64), (3, 2, 200, 64)))
    lens64 = torch.tensor([0, 131, 200], dtype=torch.int32, device=dev)
    results.append(("decode_attention", "torch.bfloat16", (3, 8, 2, 200, 64, lens64.tolist(), 0.0),
                    (A.decode_attention(q64, k64, v64, lens64).float()
                     - A.decode_attention_ref(q64, k64, v64, lens64).float()).abs().max().item(),
                    BF16_TOL))
    results += clustered_cases(tt, torch, quantized=False)
    torch.cuda.synchronize()
    for name, dt, shape, err, tol in results:
        emit({"phase": "kernel_case", "kernel": name, "dtype": dt,
              "case": [str(x) for x in shape], "max_abs_err": err, "tol": tol,
              "ok": err <= tol})
    bad = [r for r in results if not r[3] <= r[4]]
    check(not bad, f"{len(bad)} kernel cases disagree with their plain versions")

    # f32 logits from bf16 operands (the lm_head of the serve path)
    from triton_distributed_tpu_torch.models.qwen import logits_f32

    x, w = rnd(4, 512, dtype=torch.bfloat16), rnd(512, 1000, dtype=torch.bfloat16)
    got = logits_f32(x, w)
    err = (got - x.float() @ w.float()).abs().max().item()
    emit({"phase": "kernel_case", "kernel": "logits_f32", "dtype": str(got.dtype),
          "max_abs_err": err, "tol": 1e-3, "ok": err <= 1e-3})
    check(got.dtype == torch.float32 and err <= 1e-3, "logits_f32 is not f32-accurate")


CLUSTER_LENS = (0, 1, 63, 64, 65, 320)   # ragged, on and off a page and a piece; the capacity


def clustered_cases(tt, torch, quantized: bool) -> list:
    """K2/K3's clustered form (bf16, D = 128) against the plain versions at G
    = 1, 2 and 8: lengths 0, 1, 63, 64, 65 and the capacity (320: five pages
    of 64), soft cap 0 and 5; the contiguous cache with a (B,) length, a 0-d
    device length and an int, then bf16 pages (or int8 pages when
    ``quantized``) in a shuffled table whose entries past a sequence's pages
    point at page 0.  A length-0 row must be exact zeros, and a result must
    not move, bit for bit, when every row past a sequence's length (and
    every page past its pages) holds NaN instead."""
    from triton_distributed_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 + quantized)
    bf = torch.bfloat16
    b, hk, d, ps = len(CLUSTER_LENS), 2, 128, PAGE
    cap = CLUSTER_LENS[-1]
    mp = cap // ps
    lens = torch.tensor(CLUSTER_LENS, dtype=torch.int32, device=dev)
    table = torch.randperm(b * mp, generator=torch.Generator().manual_seed(SEED + 12)) \
        .to(torch.int32).reshape(b, mp)
    for i, n in enumerate(CLUSTER_LENS):
        table[i, -(-n // ps):] = 0        # past the sequence's pages: page 0, never read
    table = table.to(dev)
    past = torch.arange(cap, device=dev)[None, :] >= lens[:, None]   # (B, capacity)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def nan_past(x):   # a (B, Hkv, capacity, D) cache with NaN past each length
        return x.masked_fill(past[:, None, :, None], float("nan"))

    results = []
    for g in (1, 2, 8):
        h = hk * g
        q = rnd(b, h, d)
        for cap_ in (0.0, 5.0):
            if not quantized:
                k, v = rnd(b, hk, cap, d), rnd(b, hk, cap, d)
                for kv_len in (lens, torch.tensor(65, dtype=torch.int32, device=dev), 64):
                    got = A.decode_attention(q, k, v, kv_len, soft_cap=cap_)
                    want = A.decode_attention_ref(q, k, v, kv_len, soft_cap=cap_)
                    form = "(B,)" if torch.is_tensor(kv_len) and kv_len.dim() else \
                        "0-d" if torch.is_tensor(kv_len) else "int"
                    results.append(("decode_attention[clustered]", str(bf),
                                    (g, cap_, form, CLUSTER_LENS), (got.float() - want.float())
                                    .abs().max().item(), BF16_TOL))
                    if kv_len is lens:
                        check(not got[0].any(), "clustered K2: a length-0 row is not zeros")
                        check(torch.equal(got, A.decode_attention(q, nan_past(k), nan_past(v),
                                                                  lens, soft_cap=cap_)),
                              f"clustered K2 g={g}: rows past the length moved the result")
                pk, pv = rnd(b * mp, hk, ps, d), rnd(b * mp, hk, ps, d)
                scales, name = {}, "paged_decode_attention[clustered]"
            else:
                pk, pv, ks, vs = int8_pools(torch, gen, b * mp, hk, ps, d)
                scales, name = dict(k_scale=ks, v_scale=vs), "paged_decode_attention_int8[clustered]"
            got = A.paged_decode_attention(q, pk, pv, table, lens, soft_cap=cap_, **scales)
            want = A.paged_decode_attention_ref(q, pk, pv, table, lens, soft_cap=cap_, **scales)
            results.append((name, str(bf), (g, cap_, CLUSTER_LENS),
                            (got.float() - want.float()).abs().max().item(), BF16_TOL))
            check(not got[0].any(), f"{name}: a length-0 row is not zeros")
            if not quantized:
                # NaN in every pool slot no sequence reads (the pages past each
                # sequence's, and each last page's tail)
                used = torch.zeros(b * mp, ps, dtype=torch.bool, device=dev)
                for i, n in enumerate(CLUSTER_LENS):
                    for pos in range(0, n, ps):
                        used[int(table[i, pos // ps]), :min(ps, n - pos)] = True
                nk, nv_ = (x.masked_fill(~used[:, None, :, None], float("nan")) for x in (pk, pv))
                check(torch.equal(got, A.paged_decode_attention(q, nk, nv_, table, lens,
                                                                soft_cap=cap_)),
                      f"clustered K3 g={g}: slots past the length moved the result")
    return results


def int8_pools(torch, gen, p, hk, ps, d):
    """Random int8 K/V codes and positive (P, Hkv) scales on the card."""
    dev = torch.device("cuda")

    def codes():
        return torch.randint(-127, 128, (p, hk, ps, d), generator=gen,
                             device=dev).to(torch.int8)

    def scales():
        return torch.rand((p, hk), generator=gen, device=dev) * 0.02 + 0.005

    return codes(), codes(), scales(), scales()


def written_slots(torch, table, lens, hk, ps, shape):
    """Bool mask (P, Hkv, ps) of the pool slots a K4 call appends to: page
    table[b, min(pos // ps, mp - 1)], every head, slot pos % ps."""
    mask = torch.zeros(shape[:3], dtype=torch.bool, device=table.device)
    mp = table.shape[1]
    for b, pos in enumerate(lens.tolist()):
        mask[int(table[b, min(pos // ps, mp - 1)]), :, pos % ps] = True
    return mask


def phase_fused_cases(tt, torch) -> list:
    """K3 on int8 pages and K4 (both forms) against their plain versions at
    small shapes: f32 and bf16, GQA 1/2/4/8, qk-norm on and off, ragged
    lengths with 0, a position on a page boundary and in the table's last
    slot, shuffled tables.  K4 is also held to its pools: the appended slots
    within tolerance and every other slot bit-identical (full precision), or
    every slot untouched and k_tok/v_tok within tolerance (int8)."""
    from triton_distributed_tpu_torch.ops import attention as A
    from triton_distributed_tpu_torch.ops import fused_decode as FD

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0

    results = []
    hk, ps, mp = 2, 64, 5
    p = 3 * mp
    table = torch.randperm(p, generator=torch.Generator().manual_seed(SEED + 6)) \
        .to(torch.int32).reshape(3, mp).to(dev)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for g, d in ((1, 128), (2, 64), (4, 128), (8, 128)):
            h = hk * g
            # K3 on int8 pages: lengths 0, a page boundary, the whole table
            lens = torch.tensor([0, 2 * ps, mp * ps], dtype=torch.int32, device=dev)
            q = rnd(3, h, d, dtype=dtype)
            pk, pv, ks, vs = int8_pools(torch, gen, p, hk, ps, d)
            for cap in (0.0, 5.0):
                got = A.paged_decode_attention(q, pk, pv, table, lens, soft_cap=cap,
                                               k_scale=ks, v_scale=vs)
                want = A.paged_decode_attention_ref(q, pk, pv, table, lens, soft_cap=cap,
                                                    k_scale=ks, v_scale=vs)
                check(not got[0].any(), "int8 paged decode: a length-0 row is not zeros")
                results.append(("paged_decode_attention_int8", str(dtype),
                                (g, d, cap, lens.tolist()), err(got, want), tol))
            # K4: the new token at 0, on a page boundary, in the last slot
            k_dim = 256
            x = rnd(3, k_dim, dtype=dtype)
            wqkv = rnd(k_dim, (h + 2 * hk) * d, dtype=dtype, scale=k_dim ** -0.5)
            qn, kn = rnd(d, dtype=dtype, scale=0.2) + 1, rnd(d, dtype=dtype, scale=0.2) + 1
            lens = torch.tensor([0, ps, mp * ps - 1], dtype=torch.int32, device=dev)
            for eps in (1e-6, None):
                base_k, base_v = rnd(p, hk, ps, d, dtype=dtype), rnd(p, hk, ps, d, dtype=dtype)
                kw = dict(rope_theta=1e6, qk_eps=eps)
                gk, gv = base_k.clone(), base_v.clone()
                out, _, _ = FD.fused_attn_decode(x, wqkv, qn, kn, gk, gv, table, lens, **kw)
                rk, rv = base_k.clone(), base_v.clone()
                want, _, _ = FD.fused_attn_decode_ref(x, wqkv, qn, kn, rk, rv, table, lens, **kw)
                slots = written_slots(torch, table, lens, hk, ps, base_k.shape)
                untouched = all(torch.equal(a[~slots], base[~slots])
                                for a, base in ((gk, base_k), (gv, base_v)))
                check(untouched, f"K4 {dtype} g={g}: pool slots outside the append moved")
                results.append(("fused_attn_decode", str(dtype), (g, d, eps, lens.tolist()),
                                max(err(out, want), err(gk[slots], rk[slots]),
                                    err(gv[slots], rv[slots])), tol))
                qk, qv, ks, vs = int8_pools(torch, gen, p, hk, ps, d)
                before = (qk.clone(), qv.clone(), ks.clone(), vs.clone())
                out, _, _, kt, vt = FD.fused_attn_decode(
                    x, wqkv, qn, kn, qk, qv, table, lens, k_scale=ks, v_scale=vs, **kw)
                want, _, _, kt_r, vt_r = FD.fused_attn_decode_ref(
                    x, wqkv, qn, kn, qk, qv, table, lens, k_scale=ks, v_scale=vs, **kw)
                check(all(torch.equal(a, b) for a, b in zip((qk, qv, ks, vs), before)),
                      f"K4 int8 {dtype} g={g}: the int8 pools or scales moved")
                results.append(("fused_attn_decode_int8", str(dtype), (g, d, eps, lens.tolist()),
                                max(err(out, want), err(kt, kt_r), err(vt, vt_r)), tol))
    results += clustered_cases(tt, torch, quantized=True)
    torch.cuda.synchronize()
    for name, dt, case, e, tol in results:
        emit({"phase": "kernel_case", "kernel": name, "dtype": dt,
              "case": [str(c) for c in case], "max_abs_err": e, "tol": tol,
              "ok": e <= tol})
    bad = [r for r in results if not r[3] <= r[4]]
    check(not bad, f"{len(bad)} int8 / fused cases disagree with their plain versions")
    return results


def phase_kernels_main(tt, torch) -> dict:
    """Each kernel at the Qwen3-8B main-path shapes: error, times, bound."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import attention as A

    c = tt.QWEN3_8B
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    bf = torch.bfloat16
    h, hk, d = c.num_heads, c.num_kv_heads, c.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=bf)

    rows = {}
    src = "triton_distributed_tpu_torch/csrc/"

    # K1: causal prefill, B x 1024 tokens
    q, k, v = rnd(BATCH, h, PROMPT, d), rnd(BATCH, hk, PROMPT, d), rnd(BATCH, hk, PROMPT, d)
    got = A.flash_attention(q, k, v, causal=True)
    err = (got.float() - A.flash_attention_ref(q, k, v, causal=True).float()).abs().max().item()
    _, ms = perf_func(lambda: A.flash_attention(q, k, v, causal=True))
    _, plain_ms = perf_func(lambda: A.flash_attention_ref(q, k, v, causal=True), iters=5)
    _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    flops = 4 * BATCH * h * PROMPT * PROMPT * d / 2   # causal: half the square
    b_ms, b_by = bound(flops, nbytes(q, k, v, got), H100_BF16_FLOPS)
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda", source=src + "flash_attention.cu",
        replaces="triton_distributed_tpu/ops/attention.py:116",
        max_abs_err=err, tol=BF16_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h},{PROMPT},{d}) kv ({BATCH},{hk},{PROMPT},{d}) bf16 causal")

    # K2: contiguous decode at kv_len 1056 of a 2048-position cache
    qd = rnd(BATCH, h, d)
    kc, vc = rnd(BATCH, hk, MAX_LEN, d), rnd(BATCH, hk, MAX_LEN, d)
    got = A.decode_attention(qd, kc, vc, DECODE_POS)
    err = (got.float() - A.decode_attention_ref(qd, kc, vc, DECODE_POS).float()).abs().max().item()
    _, ms = perf_func(lambda: A.decode_attention(qd, kc, vc, DECODE_POS), iters=50)
    _, plain_ms = perf_func(lambda: A.decode_attention_ref(qd, kc, vc, DECODE_POS))
    ks, vs = kc[:, :, :DECODE_POS], vc[:, :, :DECODE_POS]
    _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], ks, vs, enable_gqa=True), iters=50)
    rows_read = 2 * BATCH * hk * DECODE_POS * d * 2
    b_ms, b_by = bound(4 * BATCH * h * DECODE_POS * d,
                       rows_read + nbytes(qd, got), H100_BF16_FLOPS)
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda", source=src + "decode_cluster.cu",
        replaces="triton_distributed_tpu/ops/attention.py:935",
        max_abs_err=err, tol=BF16_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h},{d}) cache ({BATCH},{hk},{MAX_LEN},{d}) bf16 kv_len {DECODE_POS}")
    # the served form of the length: a 0-d int32 on the card (the contiguous
    # KVCache.kv_len + 1, made once a step)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    got = A.decode_attention(qd, kc, vc, pos)
    err = (got.float() - A.decode_attention_ref(qd, kc, vc, pos).float()).abs().max().item()
    _, ms = perf_func(lambda: A.decode_attention(qd, kc, vc, pos), iters=50)
    _, plain_ms = perf_func(lambda: A.decode_attention_ref(qd, kc, vc, pos))
    rows["decode_attention[device length]"] = dict(
        rows["decode_attention"], name="decode_attention[device length]",
        counter="decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape=rows["decode_attention"]["shape"] + " (0-d int32 on the card)")

    # K3: paged decode, page 64, shuffled table, 1056 positions per sequence
    ps, mp = 64, MAX_LEN // 64
    pk, pv = rnd(BATCH * mp, hk, ps, d), rnd(BATCH * mp, hk, ps, d)
    table = torch.randperm(BATCH * mp, generator=torch.Generator().manual_seed(SEED)) \
        .to(torch.int32).reshape(BATCH, mp).to(dev)
    lens = torch.full((BATCH,), DECODE_POS, dtype=torch.int32, device=dev)
    got = A.paged_decode_attention(qd, pk, pv, table, lens)
    err = (got.float() - A.paged_decode_attention_ref(qd, pk, pv, table, lens).float()).abs().max().item()
    _, ms = perf_func(lambda: A.paged_decode_attention(qd, pk, pv, table, lens), iters=50)
    _, plain_ms = perf_func(lambda: A.paged_decode_attention_ref(qd, pk, pv, table, lens))
    gk = pk[table.long()].permute(0, 2, 1, 3, 4).reshape(BATCH, hk, MAX_LEN, d)[:, :, :DECODE_POS]
    gv = pv[table.long()].permute(0, 2, 1, 3, 4).reshape(BATCH, hk, MAX_LEN, d)[:, :, :DECODE_POS]
    _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], gk, gv, enable_gqa=True), iters=50)
    b_ms, b_by = bound(4 * BATCH * h * DECODE_POS * d,
                       rows_read + nbytes(qd, got, lens) + BATCH * mp * 4,
                       H100_BF16_FLOPS)
    rows["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda", source=src + "decode_cluster.cu",
        replaces="triton_distributed_tpu/ops/attention.py:1096",
        max_abs_err=err, tol=BF16_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h},{d}) pool ({BATCH * mp},{hk},{ps},{d}) bf16 seq_lens {DECODE_POS}")
    # K3 on bf16 pages at the Qwen3-30B-A3B shape: 32 q heads over 4 kv heads (G = 8)
    c30 = tt.QWEN3_30B_A3B
    h30, hk30 = c30.num_heads, c30.num_kv_heads
    q30 = rnd(BATCH, h30, d)
    pk30, pv30 = pk[:, :hk30].contiguous(), pv[:, :hk30].contiguous()
    got = A.paged_decode_attention(q30, pk30, pv30, table, lens)
    err = (got.float() - A.paged_decode_attention_ref(q30, pk30, pv30, table, lens).float()
           ).abs().max().item()
    _, ms = perf_func(lambda: A.paged_decode_attention(q30, pk30, pv30, table, lens), iters=50)
    _, plain_ms = perf_func(lambda: A.paged_decode_attention_ref(q30, pk30, pv30, table, lens))
    _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
        q30[:, :, None], gk[:, :hk30], gv[:, :hk30], enable_gqa=True), iters=50)
    b_ms, b_by = bound(4 * BATCH * h30 * DECODE_POS * d,
                       rows_read // 2 + nbytes(q30, got, lens) + BATCH * mp * 4,
                       H100_BF16_FLOPS)
    rows["paged_decode_attention[Qwen3-30B-A3B]"] = dict(
        rows["paged_decode_attention"], name="paged_decode_attention[Qwen3-30B-A3B]",
        counter="paged_decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h30},{d}) pool ({BATCH * mp},{hk30},{ps},{d}) bf16 seq_lens {DECODE_POS}")
    rows.update(fused_main_rows(tt, torch, g, qd, table, lens))
    torch.cuda.synchronize()
    for row in rows.values():
        emit({"phase": "kernel_main", **row})
        check(row["max_abs_err"] <= BF16_TOL,
              f"{row['name']} disagrees with its plain version: {row['max_abs_err']}")
    return rows


def fused_main_rows(tt, torch, g, qd, table, lens) -> dict:
    """K3 on int8 pages, and K4 in both forms, at the Qwen3-8B decode shapes
    (B = 4, position 1056, pages of 64 in a shuffled table).  K4's
    comparison is the per-kernel chain of the psum step that it replaces
    (qkv product, qk-norms, RoPE, append, K3); for K3-int8 it is SDPA over a
    cache dequantized and gathered beforehand (not timed)."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.lang import quant
    from triton_distributed_tpu_torch.models import kv_cache as KV
    from triton_distributed_tpu_torch.ops import attention as A
    from triton_distributed_tpu_torch.ops import fused_decode as FD
    from triton_distributed_tpu_torch.ops.rope import apply_rope, rope_freqs

    c = tt.QWEN3_8B
    dev = torch.device("cuda")
    bf = torch.bfloat16
    h, hk, d, k_dim = c.num_heads, c.num_kv_heads, c.head_dim, c.hidden
    ps, mp = PAGE, MAX_LEN // PAGE
    p = BATCH * mp
    src = "triton_distributed_tpu_torch/csrc/"
    pages_read = BATCH * -(-DECODE_POS // ps)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def err(*pairs):
        return max((a.float() - b.float()).abs().max().item() for a, b in pairs)

    rows = {}
    # K3 on int8 pages
    ck, cv, ks, vs = int8_pools(torch, g, p, hk, ps, d)
    scales = dict(k_scale=ks, v_scale=vs)
    got = A.paged_decode_attention(qd, ck, cv, table, lens, **scales)
    want = A.paged_decode_attention_ref(qd, ck, cv, table, lens, **scales)
    _, ms = perf_func(lambda: A.paged_decode_attention(qd, ck, cv, table, lens, **scales),
                      iters=50)
    _, plain_ms = perf_func(lambda: A.paged_decode_attention_ref(qd, ck, cv, table, lens,
                                                                 **scales))
    dk = quant.dequantize_pages(ck, ks, bf)
    dv = quant.dequantize_pages(cv, vs, bf)
    gk = A.gather_pages(dk, table)[0][:, :, :DECODE_POS]
    gv = A.gather_pages(dv, table)[0][:, :, :DECODE_POS]
    _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], gk, gv, enable_gqa=True), iters=50)
    int8_rows = 2 * BATCH * hk * DECODE_POS * d
    b_ms, b_by = bound(4 * BATCH * h * DECODE_POS * d,
                       int8_rows + 2 * pages_read * hk * 4 + nbytes(qd, got, lens)
                       + BATCH * mp * 4, H100_BF16_FLOPS)
    rows["paged_decode_attention_int8"] = dict(
        name="paged_decode_attention_int8", route="cuda",
        source=src + "decode_cluster.cu",
        replaces="triton_distributed_tpu/ops/attention.py:1096",
        max_abs_err=err((got, want)), tol=BF16_TOL, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h},{d}) int8 pool ({p},{hk},{ps},{d}) seq_lens {DECODE_POS}")

    # K4, both forms
    x = rnd(BATCH, k_dim)
    wqkv = rnd(k_dim, (h + 2 * hk) * d, scale=0.02)
    qn, kn = rnd(d, scale=0.1) + 1, rnd(d, scale=0.1) + 1
    kw = dict(rope_theta=c.rope_theta, qk_eps=c.rms_eps)
    cos, sin = rope_freqs(lens.float()[:, None, None], d, theta=c.rope_theta)

    def chain(cache):
        """The psum step's attention side for one layer (no o-proj)."""
        qkv = torch.matmul(x, wqkv)
        q_, k_, v_ = qkv.split([h * d, hk * d, hk * d], dim=-1)
        q_ = tt.rms_norm(q_.reshape(BATCH, h, 1, d), qn, c.rms_eps)
        k_ = tt.rms_norm(k_.reshape(BATCH, hk, 1, d), kn, c.rms_eps)
        q_ = apply_rope(q_, cos, sin)[:, :, 0].contiguous()
        KV.append_token(cache, 0, apply_rope(k_, cos, sin)[:, :, 0],
                        v_.reshape(BATCH, hk, d))
        return A.paged_decode_attention(q_, cache.k[0], cache.v[0], table, lens + 1,
                                        **KV.layer_scales(cache, 0))

    for quant in (False, True):
        if quant:
            pk, pv, ks, vs = int8_pools(torch, g, p, hk, ps, d)
            scales = dict(k_scale=ks, v_scale=vs)
            name, kv_bytes = "fused_attn_decode_int8", int8_rows + 2 * pages_read * hk * 4
        else:
            pk, pv = rnd(p, hk, ps, d), rnd(p, hk, ps, d)
            scales = {}
            name, kv_bytes = "fused_attn_decode", 2 * int8_rows
        args = (x, wqkv, qn, kn)
        gk, gv = pk.clone(), pv.clone()
        got = FD.fused_attn_decode(*args, gk, gv, table, lens, **kw, **scales)
        rk, rv = pk.clone(), pv.clone()
        want = FD.fused_attn_decode_ref(*args, rk, rv, table, lens, **kw, **scales)
        pairs = [(got[0], want[0])] + ([(got[3], want[3]), (got[4], want[4])] if quant
                                       else [(gk, rk), (gv, rv)])
        e = err(*pairs)
        _, ms = perf_func(lambda: FD.fused_attn_decode(*args, gk, gv, table, lens, **kw,
                                                       **scales), iters=50)
        _, plain_ms = perf_func(lambda: FD.fused_attn_decode_ref(
            *args, rk, rv, table, lens, **kw, **scales), iters=5)
        cache = KV.PagedKVCache(k=rk[None], v=rv[None], block_table=table, seq_lens=lens,
                                k_scale=ks[None] if quant else None,
                                v_scale=vs[None] if quant else None)
        _, chain_ms = perf_func(lambda: chain(cache), iters=50)
        # where K4's time goes: the same call with an empty prefix (the
        # projection, the finalize and the token alone), and cuBLAS reading
        # the same weights
        zero = torch.zeros_like(lens)
        _, empty_prefix_ms = perf_func(lambda: FD.fused_attn_decode(
            *args, gk, gv, table, zero, **kw, **scales), iters=50)
        _, qkv_matmul_ms = perf_func(lambda: torch.matmul(x, wqkv), iters=50)
        out_bytes = nbytes(got[0]) + 2 * BATCH * hk * d * 2   # out, and the token's k/v
        b_ms, b_by = bound(2 * BATCH * k_dim * wqkv.shape[1] + 4 * BATCH * h * DECODE_POS * d,
                           nbytes(x, wqkv, qn, kn, table, lens) + kv_bytes + out_bytes,
                           H100_BF16_FLOPS)
        rows[name] = dict(
            name=name, route="cuda", source=src + "fused_decode.cu",
            replaces="triton_distributed_tpu/ops/fused_decode.py:112",
            max_abs_err=e, tol=BF16_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, chain_ms=chain_ms,
            empty_prefix_ms=empty_prefix_ms, qkv_matmul_ms=qkv_matmul_ms,
            shape=(f"x ({BATCH},{k_dim}) wqkv ({k_dim},{wqkv.shape[1]}) "
                   f"{'int8' if quant else 'bf16'} pool ({p},{hk},{ps},{d}) pos {DECODE_POS}"))
    return rows


# ---------------------------------------------------------------------------
# MoE: K5 and the Qwen3-30B-A3B path

MOE_TOKENS = BATCH * PROMPT    # prefill tokens; x top_k rows into K5


def k5_share(got, want, atol: float, rtol: float) -> float:
    """The largest |got - want| as a share of its element's limit
    ``atol + rtol |want|``: 1 or below passes."""
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def k5_limits(torch, out_dtype) -> tuple[float, float]:
    return (BF16_TOL, K5_RTOL) if out_dtype == torch.bfloat16 else (F32_TOL, 0.0)


def schedule_mismatches(torch, splits: list, t: int) -> tuple[int, list]:
    """K5's derivation of its slot schedule (the decode and f32 forms), run
    alone on the card (``derived_tile_schedule`` on a CUDA tensor), against
    ``grouped_tile_schedule`` on the CPU, at every m-tile those forms are
    built for.  Returns the slots compared and the fields that differ."""
    from triton_distributed_tpu_torch.ops import group_gemm as G
    from triton_distributed_tpu_torch.ops.swizzle import derived_tile_schedule

    host = torch.tensor(splits, dtype=torch.int32)
    slots, bad = 0, []
    for bm in sorted({cfg.bm for tiles in G.KERNEL_CONFIGS.values() for cfg in tiles
                      if cfg not in G.UNIT_CONFIGS}):
        card = derived_tile_schedule(host.cuda(), t, bm)
        plain = derived_tile_schedule(host, t, bm)
        slots += plain["valid"].numel()
        bad += [f"bm {bm} {f}" for f in plain if not torch.equal(card[f].cpu(), plain[f])]
    return slots, bad


UNIT_COLS = (200, 1536, 2048)   # output widths the prefill form's units are checked at


def units_mismatches(torch, splits: list, t: int, cols=UNIT_COLS) -> tuple[int, list]:
    """K5's prefill form's derivation of its work units, run alone on the
    card (``derived_work_units`` on a CUDA tensor), against the mirror
    ``grouped_work_units`` on the CPU, at each width of ``cols``.  Returns
    the units compared and the fields that differ."""
    from triton_distributed_tpu_torch.ops.swizzle import derived_work_units

    host = torch.tensor(splits, dtype=torch.int32)
    units, bad = 0, []
    for n in cols:
        card = derived_work_units(host.cuda(), t, n)
        plain = derived_work_units(host, t, n)
        units += int(plain["valid"].sum())
        bad += [f"N {n} {f}" for f in plain if not torch.equal(card[f].cpu(), plain[f])]
    return units, bad


def phase_group_gemm_cases(tt, torch) -> list:
    """K5 against its plain version at small shapes, f32 and bf16 (both
    forms, bf16 and f32 results): E 1, 8 and 128; empty groups; all rows in
    one group; sum(splits) below T, with those rows held to exactly zero;
    T 1, 37, 385, 1000 and 1100; K and N that are not multiples of the tile;
    group ends at 127, 128 and 129 rows, and N 200 and 1536 against the
    prefill form's 256-wide tile.  Then K5's slot schedule and its prefill
    work units, as its blocks derive them, against the PyTorch mirrors,
    over these splits and others that put group ends on, one row before and
    one row after every tile edge."""
    from triton_distributed_tpu_torch.ops import group_gemm as G

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    results = []
    cases = (  # (T, K, N, splits)
        (1, 48, 200, [1]),
        (37, 48, 200, [5, 0, 7, 3, 0, 9, 4, 2]),
        (37, 200, 48, [0, 0, 0, 30, 0, 0, 0, 0]),
        (1000, 200, 48, [0] * 127 + [1000]),
        (1000, 256, 136, [7 * (i % 3) for i in range(128)]),
        (1000, 48, 200, [int(v) for v in torch.multinomial(
            torch.ones(128), 900, replacement=True,
            generator=torch.Generator().manual_seed(SEED)).bincount(minlength=128)]),
        (385, 72, 200, [127, 128, 129, 1]),
        (1100, 512, 1536, [129, 0, 127, 128, 256, 1, 300]),
    )
    forms = [(torch.float32, None, None)] + [
        (torch.bfloat16, cfg, out)
        for cfg in (G.DECODE_CONFIG, G.PREFILL_CONFIG)
        for out in (None, torch.float32)]
    for t, k, n, splits in cases:
        e = len(splits)
        # unit-variance outputs, as the main path's products have
        x = torch.randn((t, k), generator=gen, device=dev)
        w = torch.randn((e, k, n), generator=gen, device=dev) / k ** 0.5
        s = torch.tensor(splits, dtype=torch.int32, device=dev)
        total = sum(splits)
        for dtype, cfg, out_dtype in forms:
            xd, wd = x.to(dtype), w.to(dtype)
            got = G.grouped_matmul(xd, wd, s, config=cfg, out_dtype=out_dtype)
            want = G.grouped_matmul_ref(xd, wd, s, out_dtype=out_dtype)
            check(got.dtype == (out_dtype or dtype), f"K5 returned {got.dtype}")
            check(total == t or not got[total:].any(),
                  f"K5 T={t} splits={splits}: rows past sum(splits) are not zero")
            atol, rtol = k5_limits(torch, got.dtype)
            results.append(("grouped_matmul", f"{dtype}->{got.dtype}",
                            (t, k, n, e, total, cfg and (cfg.bm, cfg.bn, cfg.bk)),
                            (got.float() - want.float()).abs().max().item(),
                            [atol, rtol], k5_share(got, want, atol, rtol)))
    torch.cuda.synchronize()
    for name, dt, case, e, tol, share in results:
        emit({"phase": "kernel_case", "kernel": name, "dtype": dt,
              "case": [str(c) for c in case], "max_abs_err": e, "tol": tol,
              "worst_share_of_tol": share, "ok": share <= 1.0})
    bad = [r for r in results if not r[5] <= 1.0]
    check(not bad, f"{len(bad)} grouped GEMM cases disagree with the plain version")

    rng = torch.Generator().manual_seed(SEED + 13)
    sched_cases = [(t, splits) for t, _, _, splits in cases] + [(37, [0] * 8)]
    for bm in (16, 32, 64, 128):   # group ends on, before and after tile edges
        sched_cases += [(4 * bm, [bm, 0, 2 * bm, bm]),
                        (4 * bm + 3, [bm - 1, 2, bm - 1, 0, bm + 1, 1]),
                        (3 * bm, [1] * bm + [0, bm - 1])]
    for t in (1000, 4096):   # random, with empty experts and a zero tail
        counts = torch.multinomial(torch.ones(128), t - 17, replacement=True,
                                   generator=rng).bincount(minlength=128)
        sched_cases.append((t, (counts * (torch.rand(128, generator=rng) > 0.2)).tolist()))
    slots, units, bad = 0, 0, []
    for t, splits in sched_cases:
        n, wrong = schedule_mismatches(torch, splits, t)
        u, wrong_units = units_mismatches(torch, splits, t)
        slots += n
        units += u
        bad += [f"T={t} splits={splits}: {w}" for w in wrong + wrong_units]
    emit({"phase": "kernel_schedule", "kernel": "grouped_matmul", "cases": len(sched_cases),
          "slots": slots, "units": units, "differing": bad[:8], "ok": not bad})
    check(not bad, f"K5's schedule or work units differ from their mirrors: {bad[:4]}")
    return results


def phase_moe_attention_cases(tt, torch) -> None:
    """K1, K3 and K4 once each at the Qwen3-30B-A3B attention shapes (32 q
    heads, 4 kv heads: GQA 8; hidden 2048) against their plain versions;
    K1's time there beside SDPA's (a `kernel_main` line outside the kernels
    line)."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import attention as A
    from triton_distributed_tpu_torch.ops import fused_decode as FD

    c = tt.QWEN3_30B_A3B
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    h, hk, d, k_dim = c.num_heads, c.num_kv_heads, c.head_dim, c.hidden
    ps, mp = PAGE, MAX_LEN // PAGE

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    rows = []
    q, k, v = rnd(BATCH, h, PROMPT, d), rnd(BATCH, hk, PROMPT, d), rnd(BATCH, hk, PROMPT, d)
    rows.append(("flash_attention", err(A.flash_attention(q, k, v, causal=True),
                                        A.flash_attention_ref(q, k, v, causal=True))))
    _, ms = perf_func(lambda: A.flash_attention(q, k, v, causal=True))
    _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    b_ms, b_by = bound(4 * BATCH * h * PROMPT * PROMPT * d / 2,
                       nbytes(q, k, v, q), H100_BF16_FLOPS)
    emit({"phase": "kernel_main", "name": "flash_attention[Qwen3-30B-A3B]", "ms": ms,
          "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"q ({BATCH},{h},{PROMPT},{d}) kv ({BATCH},{hk},{PROMPT},{d}) bf16 causal"})
    qd = rnd(BATCH, h, d)
    pk, pv = rnd(BATCH * mp, hk, ps, d), rnd(BATCH * mp, hk, ps, d)
    table = torch.randperm(BATCH * mp, generator=torch.Generator().manual_seed(SEED)) \
        .to(torch.int32).reshape(BATCH, mp).to(dev)
    lens = torch.full((BATCH,), DECODE_POS, dtype=torch.int32, device=dev)
    rows.append(("paged_decode_attention",
                 err(A.paged_decode_attention(qd, pk, pv, table, lens),
                     A.paged_decode_attention_ref(qd, pk, pv, table, lens))))
    x = rnd(BATCH, k_dim)
    wqkv = rnd(k_dim, (h + 2 * hk) * d, scale=0.02)
    qn, kn = rnd(d, scale=0.1) + 1, rnd(d, scale=0.1) + 1
    kw = dict(rope_theta=c.rope_theta, qk_eps=c.rms_eps)
    gk, gv, rk, rv = pk.clone(), pv.clone(), pk.clone(), pv.clone()
    got = FD.fused_attn_decode(x, wqkv, qn, kn, gk, gv, table, lens, **kw)
    want = FD.fused_attn_decode_ref(x, wqkv, qn, kn, rk, rv, table, lens, **kw)
    rows.append(("fused_attn_decode", max(err(got[0], want[0]), err(gk, rk), err(gv, rv))))
    torch.cuda.synchronize()
    for name, e in rows:
        emit({"phase": "kernel_case", "kernel": name, "dtype": "torch.bfloat16",
              "case": [f"Qwen3-30B-A3B attention: h {h} hk {hk} d {d} hidden {k_dim}"],
              "max_abs_err": e, "tol": BF16_TOL, "ok": e <= BF16_TOL})
    bad = [r for r in rows if not r[1] <= BF16_TOL]
    check(not bad, f"{bad}: disagree with the plain versions at the MoE attention shapes")


def moe_routed(tt, torch, layer, x):
    """(x_sorted, splits, h): the rows of a real routing of ``x`` through
    the layer's router, sorted by expert, and the activation of their
    up-projection (the input of the down-projection)."""
    c = tt.QWEN3_30B_A3B
    moe = tt.MoEMLP(num_experts=c.num_experts, top_k=c.top_k, swiglu=True)
    x_sorted, splits, _, _ = moe._route_and_sort(x, layer.router)
    h = moe._combine(tt.grouped_matmul(x_sorted, layer.w_up, splits))
    return x_sorted, splits, h


def group_gemm_main_rows(tt, torch) -> dict:
    """K5 at the four products of the Qwen3-30B-A3B main path (B = 4,
    prompts of 1024: 32768 prefill rows; 32 decode rows), with splits from a
    real routing of random activations through a random router: error,
    time, plain version's time, bound and one library call for the same
    function.  The bound counts the weights of the experts the splits touch
    once, x and out once.  The activations have unit variance, as the
    RMS-normed hidden state the path feeds the up-projection; the limit is
    shown to reject two faulty results at each shape: every row multiplied
    by its neighbour group's weights, and the first k-tile left out.  K5's
    schedule for these splits is held to the mirror as well."""
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import group_gemm as G

    c = tt.QWEN3_30B_A3B
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    layer = tt.MoEMLP(num_experts=c.num_experts, top_k=c.top_k, swiglu=True).init(
        g, c.hidden, c.moe_intermediate, dtype=c.dtype, device=dev)
    rows = {}
    library = "torch._grouped_mm"
    for stage, tokens in (("prefill", MOE_TOKENS), ("decode", BATCH)):
        x = torch.randn((tokens, c.hidden), generator=g, device=dev).to(c.dtype)
        x_sorted, splits, h = moe_routed(tt, torch, layer, x)
        host_splits = splits.cpu()
        n_slots, wrong = schedule_mismatches(torch, host_splits.tolist(), x_sorted.shape[0])
        n_units, wrong_units = units_mismatches(
            torch, host_splits.tolist(), x_sorted.shape[0],
            (layer.w_up.shape[2], layer.w_dn.shape[2]))
        wrong += wrong_units
        emit({"phase": "kernel_schedule", "kernel": "grouped_matmul", "stage": stage,
              "slots": n_slots, "units": n_units, "differing": wrong, "ok": not wrong})
        check(not wrong, f"K5's schedule or work units differ from their mirrors at {stage}")
        for form, a, w in (("up", x_sorted, layer.w_up), ("down", h, layer.w_dn)):
            got = G.grouped_matmul(a, w, splits)
            want = G.grouped_matmul_ref(a, w, host_splits)
            e = (got.float() - want.float()).abs().max().item()
            share = k5_share(got, want, BF16_TOL, K5_RTOL)
            bk = G.default_config(a.shape[0], a.dtype).bk
            mutants = {
                "neighbour_group": k5_share(G.grouped_matmul_ref(
                    a, w.roll(1, dims=0), host_splits), want, BF16_TOL, K5_RTOL),
                "first_k_tile_left_out": k5_share(G.grouped_matmul_ref(
                    a[:, bk:], w[:, bk:], host_splits), want, BF16_TOL, K5_RTOL)}
            _, ms = perf_func(lambda: G.grouped_matmul(a, w, splits), iters=50)
            _, plain_ms = perf_func(lambda: G.grouped_matmul_ref(a, w, host_splits), iters=5)
            offs = torch.cumsum(splits, 0, dtype=torch.int32)
            try:
                _, lib_ms = perf_func(lambda: torch._grouped_mm(a, w, offs=offs), iters=50)
            except (AttributeError, RuntimeError) as exc:   # older torch: the loop
                emit({"phase": "kernel_main", "note": f"torch._grouped_mm unusable: {exc}"})
                library = "per-expert torch.matmul loop"
                _, lib_ms = perf_func(lambda: G.grouped_matmul_ref(a, w, host_splits), iters=5)
            t, k = a.shape
            n = w.shape[2]
            touched = int((host_splits > 0).sum())
            b_ms, b_by = bound(2 * t * k * n,
                               nbytes(a, got, splits) + touched * k * n * w.element_size(),
                               H100_BF16_FLOPS)
            name = f"grouped_matmul[{stage} {form}]"
            rows[name] = dict(
                name=name, route="cuda", source="triton_distributed_tpu_torch/csrc/group_gemm.cu",
                replaces="triton_distributed_tpu/ops/group_gemm.py:69",
                max_abs_err=e, tol=[BF16_TOL, K5_RTOL], worst_share_of_tol=share,
                faulty_share_of_tol=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library=library,
                experts_touched=touched, max_rows_per_expert=int(host_splits.max()),
                form=(t, k, n), shape=f"x ({t},{k}) w ({w.shape[0]},{k},{n}) bf16")
    del layer
    torch.cuda.synchronize()
    for row in rows.values():
        emit({"phase": "kernel_main", **row})
        check(row["worst_share_of_tol"] <= 1.0,
              f"{row['name']} disagrees with its plain version: {row['max_abs_err']}")
        check(min(row["faulty_share_of_tol"].values()) > 1.0,
              f"{row['name']}: the limit does not reject a faulty result "
              f"{row['faulty_share_of_tol']}")
    return rows


# ---------------------------------------------------------------------------
# local ops: K6 (the tuned matmul), K7 (decode states), K8 (the chunk fold)

K6_RTOL = 2.0 ** -7   # bf16 results: BF16_TOL + K6_RTOL |plain|, as K5's
# K7 and K8 states against their plain versions: acc / l (the attention the
# state stands for) within BF16_TOL rms(row) + STATE_RTOL |plain| per element,
# the rms over the row's D values of the plain side (an attention row over N
# keys has a spread of ~sqrt(e / N), 0.027 at 4096 keys, so an absolute 0.02
# would be as large as the values); l within STATE_RTOL relative, m within
# STATE_M_TOL; p is rounded to bf16 at running maxima that differ in the two
STATE_RTOL = 2.0 ** -7
STATE_M_TOL = 1e-3
FAULT_TILE = 64   # the keys a faulty state leaves out: one kernel kv tile
STATE_TOL = {"out": [BF16_TOL, "x rms(row)", STATE_RTOL, "x |plain|"],
             "l_rtol": STATE_RTOL, "m": STATE_M_TOL}
MATMUL_MAIN = (   # (label, M, K, N): bench.py's GEMMs, Qwen3-8B's prefill at B = 4 x 1024
    ("bench 7168^3", 7168, 7168, 7168),
    ("bench 4096x7168x7168", 4096, 7168, 7168),
    ("Qwen3-8B qkv", BATCH * PROMPT, 4096, 6144),
    ("Qwen3-8B o", BATCH * PROMPT, 4096, 4096),
    ("Qwen3-8B gate_up", BATCH * PROMPT, 4096, 24576),
    ("Qwen3-8B down", BATCH * PROMPT, 12288, 4096),
    ("Qwen3-8B lm_head", BATCH * PROMPT, 4096, 151936),
)
FRESH_TUNES = ("bench 7168^3", "Qwen3-8B gate_up")
STATE_LENS = (DECODE_POS, 1, MAX_LEN, 700)   # K7's ragged kv_len, B = 4
RING, RING_CHUNK = 4, 1024   # K8: the last rank of a 4-way ring at 4096 context


def k6_operands(torch, gen, m, k, n, dtype):
    """Unit-variance A and B scaled by 1/sqrt(K): outputs of unit variance."""
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5).to(dtype)
    return a, b


def k6_limits(torch, out_dtype) -> tuple[float, float]:
    return (BF16_TOL, K6_RTOL) if out_dtype == torch.bfloat16 else (F32_TOL, 0.0)


def phase_matmul_cases(tt, torch) -> None:
    """K6 against its plain version at the edges: M 1, 37, 1000, 4096 (partial
    last tiles), N and K 136 and 4104 (off every tile), every built tile,
    bf16 -> bf16, bf16 -> f32 and f32."""
    from triton_distributed_tpu_torch.ops import matmul as M

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    results = []
    for m in (1, 37, 1000, 4096):
        for n in (136, 4104):
            for k in (136, 4104):
                a32, b32 = k6_operands(torch, gen, m, k, n, torch.float32)
                for dtype, outs in ((torch.bfloat16, (None, torch.float32)),
                                    (torch.float32, (None,))):
                    a, b = a32.to(dtype), b32.to(dtype)
                    for tile in M.KERNEL_TILES[dtype]:
                        for out in outs:
                            got = M.matmul(a, b, config=tile, out_dtype=out)
                            want = M.matmul_ref(a, b, out)
                            atol, rtol = k6_limits(torch, got.dtype)
                            check(got.dtype == (out or dtype), f"K6 returned {got.dtype}")
                            results.append((f"{dtype}->{got.dtype}", (m, n, k, tile),
                                            (got.float() - want.float()).abs().max().item(),
                                            [atol, rtol], k5_share(got, want, atol, rtol)))
    torch.cuda.synchronize()
    for dt, case, e, tol, share in results:
        emit({"phase": "kernel_case", "kernel": "matmul", "dtype": dt,
              "case": [str(c) for c in case], "max_abs_err": e, "tol": tol,
              "worst_share_of_tol": share, "ok": share <= 1.0})
    bad = [r for r in results if not r[4] <= 1.0]
    check(not bad, f"{len(bad)} matmul cases disagree with the plain version")


def count_sweep_calls(at, calls: dict):
    """Wrap the tuner's ``autotune`` so each candidate thunk's calls are
    counted in ``calls`` (str(candidate) -> n): the sweep's K6 launches,
    counted apart from the kernel's own counter.  Returns the original."""
    real = at.autotune

    def counting(name, key, candidates, make_thunk, **kw):
        def make(c):
            thunk = make_thunk(c)

            def run():
                calls[str(c)] = calls.get(str(c), 0) + 1
                return thunk()
            return run
        return real(name, key, candidates, make, **kw)

    at.autotune = counting
    return real


def local_inputs(tt, torch) -> dict:
    """The main-path inputs of K6, K7 and K8, made from the seed."""
    c = tt.QWEN3_8B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    bf = torch.bfloat16
    h, hk, d = c.num_heads, c.num_kv_heads, c.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    ins = {"gemm": {label: k6_operands(torch, gen, m, k, n, bf)
                    for label, m, k, n in MATMUL_MAIN}}
    ins["q"] = rnd(BATCH, h, d)
    ins["kv"] = (rnd(BATCH, hk, MAX_LEN, d), rnd(BATCH, hk, MAX_LEN, d))
    ins["lens"] = torch.tensor(STATE_LENS, dtype=torch.int32, device="cuda")
    mp = MAX_LEN // PAGE
    ins["pages"] = (rnd(BATCH * mp, hk, PAGE, d), rnd(BATCH * mp, hk, PAGE, d))
    ins["int8_pages"] = int8_pools(torch, gen, BATCH * mp, hk, PAGE, d)
    ins["table"] = torch.randperm(BATCH * mp, generator=torch.Generator().manual_seed(SEED)) \
        .to(torch.int32).reshape(BATCH, mp).to("cuda")
    s = RING * RING_CHUNK
    ins["ring"] = (rnd(1, h, s, d), rnd(1, hk, s, d), rnd(1, hk, s, d))
    return ins


def local_ops_path(tt, torch, at, ins) -> dict:
    """The local ops through the entry points a user calls, with the launch
    counters set to 0 just before and read just after: K6 with its default
    tile at each main shape, two fresh tunes (their sweeps launch every
    tile) and the call that serves each crown; K7 over the contiguous cache
    and over bf16 and int8 pages, merged; K8 folding the four chunks of the
    ring's last rank."""
    from triton_distributed_tpu_torch.ops.matmul import DEFAULT_TILES

    tile = DEFAULT_TILES[torch.bfloat16]
    calls: dict = {}
    out: dict = {"tunes": {}}
    q, (k, v), lens, table = ins["q"], ins["kv"], ins["lens"], ins["table"]
    qr, kr, vr = ins["ring"]
    sq = RING_CHUNK
    q_last = qr[:, :, -sq:].contiguous()
    chunks = [(kr[:, :, j * sq:(j + 1) * sq].contiguous(),
               vr[:, :, j * sq:(j + 1) * sq].contiguous()) for j in range(RING)]
    q_off = torch.tensor((RING - 1) * sq, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    tt.reset_launch_counts()
    real = count_sweep_calls(at, calls)
    try:
        for label, (a, b) in ins["gemm"].items():
            out[label] = tt.matmul(a, b, bm=tile[0], bn=tile[1], bk=tile[2])
        for label in FRESH_TUNES:
            a, b = ins["gemm"][label]
            before = dict(calls)
            crown = tt.fresh_tune_matmul(a, b)
            cands, res = at.last_result("matmul")
            served = tt.matmul(a, b)   # config=None: the crown, from memory
            k6_calls = sum(calls.get(str(c), 0) - before.get(str(c), 0)
                           for c in cands if not isinstance(c, at.LibraryBackend))
            out["tunes"][label] = dict(crown=crown, candidates=cands,
                                       result=res, served=served,
                                       k6_calls=k6_calls)
    finally:
        at.autotune = real
    out["state"] = tt.decode_attention_state(q, k, v, lens)
    out["merged"] = tt.merge_decode_states(*out["state"])
    pk, pv = ins["pages"]
    out["paged_state"] = tt.paged_decode_attention_state(q, pk, pv, table, lens)
    ik, iv, iks, ivs = ins["int8_pages"]
    out["int8_state"] = tt.paged_decode_attention_state(
        q, ik, iv, table, lens, k_scale=iks, v_scale=ivs)
    b, h, _, d = q_last.shape
    state = tt.init_attention_state(b, h, sq, d)
    for j, (kc, vc) in enumerate(chunks):
        state = tt.flash_attention_chunk(q_last, kc, vc, state, q_off, j * sq)
    out["fold"] = state
    torch.cuda.synchronize()
    out["launches"], out["forms"] = tt.launch_counts(), tt.launch_forms()
    out["chunks"], out["q_last"] = chunks, q_last
    return out


def out_share(torch, got, want) -> tuple[float, float]:
    """An attention output (rows along the last axis) against its plain
    version: the worst |got - want| as a share of BF16_TOL rms(row of want)
    + STATE_RTOL |want| (1 or below passes), and the worst |got - want|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    limit = BF16_TOL * w.square().mean(-1, keepdim=True).sqrt() + STATE_RTOL * w.abs()
    share = torch.where(diff > 0, diff / limit.clamp_min(1e-30), torch.zeros_like(diff))
    return share.max().item(), diff.max().item()


def state_shares(torch, got, want) -> dict:
    """Each part of a decode or chunk state against its plain version, as a
    share of its limit (1 or below passes): the attention it stands for
    (acc / l, where l > 0) by :func:`out_share`, l against STATE_RTOL
    |plain|, m against STATE_M_TOL; and whether both have the same empty
    rows.  ``out_max_abs_err`` is the attention's worst absolute error."""
    num, m, l = (x.float() for x in got)
    rn, rm, rl = (x.float() for x in want)
    live = rl > 0
    zero = torch.zeros_like(num)
    out, err = out_share(torch, torch.where(live[..., None], num / l.clamp_min(1e-30)[..., None], zero),
                         torch.where(live[..., None], rn / rl.clamp_min(1e-30)[..., None], zero))
    return {"out": out,
            "l": ((l - rl).abs() / (1e-6 + STATE_RTOL * rl.abs())).max().item(),
            "m": torch.where(live, (m - rm).abs(), torch.zeros_like(m)).max().item()
            / STATE_M_TOL,
            "same_empty": bool(torch.equal(l > 0, live)),
            "out_max_abs_err": err}


def worst(shares: dict) -> float:
    return max(shares["out"], shares["l"], shares["m"])


def empties_exact(torch, state, starts, lens) -> bool:
    """Every split starting at or past its sequence's length holds exactly
    num = 0, m = -1e30, l = 0 (the JAX masked tile's state)."""
    num, m, l = state
    empty = starts[None, :] >= lens[:, None].long()          # (B, S)
    e = empty[:, None, :].expand_as(m)
    return bool((m[e] == -1e30).all() and not l[e].any()
                and not num[e[..., None].expand_as(num)].any())


def matmul_rows(tt, torch, ins, path) -> dict:
    """K6 at the main shapes: each built tile held to the plain version
    (and the limit shown to reject a k-tile left out and a neighbour's
    n-tile) and timed; the row takes the fastest tile, beside the plain
    version, ``torch.matmul`` and the bound."""
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import matmul as M

    rows = {}
    for label, m, k, n in MATMUL_MAIN:
        a, b = ins["gemm"][label]
        want = M.matmul_ref(a, b)
        tiles = {}
        for tile in M.KERNEL_TILES[torch.bfloat16]:
            got = M.matmul(a, b, config=tile)
            share = k5_share(got, want, BF16_TOL, K6_RTOL)
            err = (got.float() - want.float()).abs().max().item()
            del got
            _, ms = perf_func(lambda: M.matmul(a, b, config=tile), iters=10)
            tiles[str(tile)] = dict(ms=ms, max_abs_err=err, worst_share_of_tol=share)
        default = str(M.DEFAULT_TILES[torch.bfloat16])
        tiles[default]["path_share_of_tol"] = k5_share(path[label], want, BF16_TOL, K6_RTOL)
        faulty = {
            "k_tile_left_out": k5_share(M.matmul_ref(a[:, 32:], b[32:]), want, BF16_TOL, K6_RTOL),
            "neighbour_n_tile": k5_share(want.roll(-128, dims=1), want, BF16_TOL, K6_RTOL)}
        _, plain_ms = perf_func(lambda: M.matmul_ref(a, b), iters=3)
        _, lib_ms = perf_func(lambda: torch.matmul(a, b), iters=10)
        best = min(tiles, key=lambda t: tiles[t]["ms"])
        b_ms, b_by = bound(2 * m * n * k, nbytes(a, b, want), H100_BF16_FLOPS)
        name = f"matmul[{label}]"
        rows[name] = dict(
            name=name, route="cuda", source="triton_distributed_tpu_torch/csrc/matmul.cu",
            replaces="triton_distributed_tpu/ops/matmul.py:37",
            max_abs_err=max(t["max_abs_err"] for t in tiles.values()),
            tol=[BF16_TOL, K6_RTOL],
            worst_share_of_tol=max(max(t["worst_share_of_tol"] for t in tiles.values()),
                                   tiles[default]["path_share_of_tol"]),
            faulty_share_of_tol=faulty, ms=tiles[best]["ms"], tile=best, tiles=tiles,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="torch.matmul", counter="matmul", form=(m, n, k),
            shape=f"a ({m},{k}) b ({k},{n}) bf16")
        del want
    return rows


def decode_state_rows(tt, torch, ins, path) -> dict:
    """K7 at the Qwen3-8B decode shapes (B = 4, cache 2048, pages of 64):
    the path's states (ragged kv_len 1056, 1, 2048, 700) held to the plain
    versions split by split and page by page, empty splits held exact, and
    the merged contiguous states, normalized, held to K2; the limit shown to
    reject a state with one split's V from the neighbouring kv head and one
    with a 64-key tile of a split left out; then each form timed at kv_len
    1056, as K2 and K3 are."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import attention as A

    q, (k, v), lens, table = ins["q"], ins["kv"], ins["lens"], ins["table"]
    pk, pv = ins["pages"]
    ik, iv, iks, ivs = ins["int8_pages"]
    b, h, d = q.shape
    hk = k.shape[1]
    sm = d ** -0.5
    n_split = A.auto_n_split(MAX_LEN)
    mp = table.shape[1]
    forms = {
        "decode_attention_state": (
            path["state"], lambda kl: A.decode_attention_state(q, k, v, kl),
            lambda kl: A.decode_attention_state_ref(q, k, v, kl, n_split, sm_scale=sm),
            torch.arange(n_split, device="cuda") * (MAX_LEN // n_split)),
        "paged_decode_attention_state": (
            path["paged_state"],
            lambda kl: A.paged_decode_attention_state(q, pk, pv, table, kl),
            lambda kl: A.paged_decode_attention_state_ref(q, pk, pv, table, kl, sm_scale=sm),
            torch.arange(mp, device="cuda") * PAGE),
        "paged_decode_attention_state_int8": (
            path["int8_state"],
            lambda kl: A.paged_decode_attention_state(q, ik, iv, table, kl,
                                                      k_scale=iks, v_scale=ivs),
            lambda kl: A.paged_decode_attention_state_ref(
                q, ik, iv, table, kl, sm_scale=sm, k_scale=iks, v_scale=ivs),
            torch.arange(mp, device="cuda") * PAGE)}
    merged_num, _, merged_l = path["merged"]
    k2 = A.decode_attention(q, k, v, lens)
    merged_share, merged_err = out_share(torch, A.safe_normalize_decode(
        merged_num[:, :, 0], merged_l[:, :, 0, None], q.dtype), k2)
    emit({"phase": "kernel_case", "kernel": "merge_decode_states", "dtype": str(q.dtype),
          "case": ["K7 states merged and normalized vs K2", str(STATE_LENS)],
          "max_abs_err": merged_err, "share_of_tol": merged_share,
          "tol": [BF16_TOL, "x rms(row)", STATE_RTOL], "ok": merged_share <= 1.0})
    check(merged_share <= 1.0, f"merged K7 states differ from K2: {merged_share} of the limit")
    # the limit must reject a faulty state: one split's V from the
    # neighbouring kv head, or one 64-key tile of a split left out
    keep = torch.arange(MAX_LEN, device="cuda")[None, :] < lens[:, None]
    s1 = MAX_LEN // n_split
    v_bad = v.clone()
    v_bad[:, :, s1:2 * s1] = v[:, :, s1:2 * s1].roll(1, dims=1)
    keep_bad = keep.clone()
    keep_bad[:, s1:s1 + FAULT_TILE] = False
    want = A.decode_attention_state_ref(q, k, v, lens, n_split, sm_scale=sm)
    faulty = {
        "neighbour_kv_head_v": state_shares(torch, A.decode_attention_state_ref(
            q, k, v_bad, lens, n_split, sm_scale=sm), want)["out"],
        "kv_tile_left_out": state_shares(torch, A.decode_states_ref(
            q, k, v, keep_bad, n_split, sm_scale=sm), want)["out"]}
    del v_bad, want
    uniform = torch.full((b,), DECODE_POS, dtype=torch.int32, device="cuda")
    gk = A.gather_pages(pk, table)[0][:, :, :DECODE_POS]
    gv = A.gather_pages(pv, table)[0][:, :, :DECODE_POS]
    dk = (A.gather_pages(ik, table, iks)[0].float()
          * A.gather_pages(ik, table, iks)[1][..., None])[:, :, :DECODE_POS].to(q.dtype)
    dv = (A.gather_pages(iv, table, ivs)[0].float()
          * A.gather_pages(iv, table, ivs)[1][..., None])[:, :, :DECODE_POS].to(q.dtype)
    library_kv = {"decode_attention_state": (k[:, :, :DECODE_POS], v[:, :, :DECODE_POS]),
                  "paged_decode_attention_state": (gk, gv),
                  "paged_decode_attention_state_int8": (dk, dv)}
    rows = {}
    for name, (got, kernel, plain, starts) in forms.items():
        shares = state_shares(torch, got, plain(lens))
        exact = empties_exact(torch, got, starts, lens)
        check(shares["same_empty"] and exact,
              f"{name}: empty splits are not num = 0, m = -1e30, l = 0 exactly")
        check(worst(shares) <= 1.0, f"{name} disagrees with its plain version: {shares}")
        _, ms = perf_func(lambda: kernel(uniform), iters=50)
        _, plain_ms = perf_func(lambda: plain(uniform), iters=10)
        lk, lv = library_kv[name]
        _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
            q[:, :, None], lk, lv, enable_gqa=True), iters=50)
        st = kernel(uniform)
        kv_bytes = 2 * b * hk * DECODE_POS * d * (1 if name.endswith("int8") else 2)
        extra = b * mp * 4 + (2 * b * mp * hk * 4 if name.endswith("int8") else 0) \
            if name.startswith("paged") else 0
        b_ms, b_by = bound(4 * b * h * DECODE_POS * d,
                           kv_bytes + extra + nbytes(q, uniform, *st), H100_BF16_FLOPS)
        rows[name] = dict(
            name=name, route="cuda", source="triton_distributed_tpu_torch/csrc/decode_attention.cu",
            replaces=("triton_distributed_tpu/ops/attention.py:584" if not name.startswith("paged")
                      else "triton_distributed_tpu/ops/attention.py:1096"),
            max_abs_err=shares["out_max_abs_err"], share_of_limits=shares,
            worst_share_of_tol=worst(shares), tol=STATE_TOL,
            **({"faulty_share_of_tol": faulty} if name == "decode_attention_state" else {}),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="scaled_dot_product_attention (normalized, over the kv_len prefix)",
            shape=(f"q ({b},{h},{d}) " + ("cache" if not name.startswith("paged") else "pool")
                   + f" bf16{' int8' if name.endswith('int8') else ''}, states at kv_len "
                   f"{list(STATE_LENS)}, timed at {DECODE_POS}"))
    return rows


def fold_rows(tt, torch, ins, path) -> dict:
    """K8 at Qwen3-8B's heads: the ring's last rank (queries 3072-4095)
    folds four chunks of 1024 keys; the folded state is held to the plain
    fold, and its finalized output to K1 over the whole 4096 (rows
    3072-4095); the limits shown to reject a fold with one chunk's V from
    the neighbouring kv head and one with a 64-key tile left out.  Each
    chunk timed beside its bound and SDPA over the same
    (q, chunk); the row is the whole fold."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import attention as A

    qr, kr, vr = ins["ring"]
    q, chunks, fold = path["q_last"], path["chunks"], path["fold"]
    b, h, sq, d = q.shape
    sm = d ** -0.5
    q_off = torch.tensor((RING - 1) * sq, dtype=torch.int32, device="cuda")
    states = [A.init_attention_state(b, h, sq, d)]
    ref = states[0]
    for j, (kc, vc) in enumerate(chunks):
        ref = A.flash_attention_chunk_ref(q, kc, vc, ref, q_off, j * sq, sm_scale=sm)
        states.append(A.flash_attention_chunk(q, kc, vc, states[-1], q_off, j * sq))
    def as_state(st):   # (m, l, acc) -> (num, m, l), as state_shares reads it
        return st[2], st[0], st[1]

    def plain_fold(j_bad=-1, bad=None):   # the plain fold, chunk j_bad as bad(k, v, kv_offset)
        st = states[0]
        for j, (kc, vc) in enumerate(chunks):
            kc, vc, off = bad(kc, vc, j * sq) if j == j_bad else (kc, vc, j * sq)
            st = A.flash_attention_chunk_ref(q, kc, vc, st, q_off, off, sm_scale=sm)
        return st

    shares = state_shares(torch, as_state(fold), as_state(ref))
    full = A.flash_attention(qr, kr, vr, causal=True)[:, :, -sq:]
    k1_share, k1_err = out_share(torch, A.finalize_attention_state(fold, q.dtype), full)
    # the limits must reject a faulty fold: one chunk's V from the
    # neighbouring kv head, or one 64-key tile of a chunk left out
    faulty = {
        "neighbour_kv_head_v": state_shares(torch, as_state(plain_fold(
            2, lambda kc, vc, off: (kc, vc.roll(1, dims=1), off))), as_state(ref))["out"],
        "kv_tile_left_out": state_shares(torch, as_state(plain_fold(
            1, lambda kc, vc, off: (kc[:, :, FAULT_TILE:], vc[:, :, FAULT_TILE:],
                                    off + FAULT_TILE))), as_state(ref))["out"]}
    emit({"phase": "kernel_case", "kernel": "flash_attention_chunk", "dtype": str(q.dtype),
          "case": [f"{RING} chunks of {sq} at q_offset {(RING - 1) * sq}", "vs plain fold",
                   "vs K1 over the whole context"],
          "share_of_limits": shares, "k1_share_of_tol": k1_share, "k1_max_abs_err": k1_err,
          "faulty_share_of_tol": faulty, "tol": STATE_TOL,
          "ok": worst(shares) <= 1.0 and k1_share <= 1.0})
    check(shares["same_empty"] and worst(shares) <= 1.0,
          f"K8's fold disagrees with the plain fold: {shares}")
    check(k1_share <= 1.0, f"K8's fold differs from K1: {k1_share} of the limit ({k1_err})")
    check(all(torch.equal(x, y) for x, y in zip(states[-1], fold)),
          "K8 is not deterministic: the path's fold differs from the same fold again")
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    flops_total = 0.0
    for j, (kc, vc) in enumerate(chunks):
        s_j = states[j]
        diag = j == RING - 1
        _, ms = perf_func(lambda: A.flash_attention_chunk(q, kc, vc, s_j, q_off, j * sq))
        _, plain_ms = perf_func(lambda: A.flash_attention_chunk_ref(
            q, kc, vc, s_j, q_off, j * sq, sm_scale=sm), iters=5)
        _, lib_ms = perf_func(lambda: F.scaled_dot_product_attention(
            q, kc, vc, is_causal=diag, enable_gqa=True))
        flops = 4 * b * h * sq * sq * d * ((sq + 1) / (2 * sq) if diag else 1.0)
        flops_total += flops
        b_ms, b_by = bound(flops, nbytes(q, kc, vc, *s_j, *states[j + 1]), H100_BF16_FLOPS)
        emit({"phase": "kernel_main", "kernel": "flash_attention_chunk", "chunk": j,
              "kv_offset": j * sq, "q_offset": (RING - 1) * sq, "diagonal": diag,
              "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
              "bound_by": b_by})
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["library_ms"] += lib_ms
    b_ms, b_by = bound(flops_total, nbytes(q, *[t for c in chunks for t in c], *states[0], *fold),
                       H100_BF16_FLOPS)
    return {"flash_attention_chunk": dict(
        name="flash_attention_chunk", route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_attention.cu",
        replaces="triton_distributed_tpu/ops/attention.py:361",
        max_abs_err=shares["out_max_abs_err"], share_of_limits=shares,
        k1_share_of_tol=k1_share, k1_max_abs_err=k1_err,
        worst_share_of_tol=max(worst(shares), k1_share), faulty_share_of_tol=faulty,
        tol=STATE_TOL, **total,
        bound_ms=b_ms, bound_by=b_by,
        library="scaled_dot_product_attention per chunk (normalized), summed",
        shape=f"q ({b},{h},{sq},{d}) bf16 at {(RING - 1) * sq}, {RING} chunks kv ({b},{kr.shape[1]},{sq},{d})")}


# K8's edge cases, bf16 at D = 128 (the wgmma body): (label, q heads, kv
# heads, q rows, chunk keys, q_offset, kv_offset, soft_cap).  A chunk wholly
# in the future; a partly visible one (delta -700, no multiple of 64); the
# diagonal chunk with the soft cap on; the Qwen3-30B-A3B heads (G = 8); Sq
# and the chunk off every tile (delta 300)
FOLD_CASES = (
    ("future", 32, 8, 1024, 1024, 0, 1024, 0.0),
    ("partly visible", 32, 8, 1024, 1024, 1000, 1700, 0.0),
    ("soft cap", 32, 8, 1024, 1024, 3072, 3072, 5.0),
    ("G = 8", 32, 4, 1024, 1024, 3072, 2048, 0.0),
    ("ragged", 32, 8, 1000, 700, 1300, 1000, 0.0),
)


def phase_fold_cases(tt, torch) -> None:
    """K8 at its edges (FOLD_CASES), each from a carried state (one random
    chunk folded by the plain version, some rows left fresh): the fold held
    to the plain fold (STATE_TOL), every row with no visible key holding its
    state bitwise (all of them in the future chunk), and the same fold with
    int offsets and with 0-d device offsets bitwise equal."""
    from triton_distributed_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    bf, d = torch.bfloat16, 128
    for label, h, hk, sq, sc, q_off, kv_off, cap in FOLD_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(bf)

        q, k0, v0, k, v = rnd(1, h, sq, d), rnd(1, hk, 256, d), rnd(1, hk, 256, d), \
            rnd(1, hk, sc, d), rnd(1, hk, sc, d)
        fresh = A.init_attention_state(1, h, sq, d)
        state = A.flash_attention_chunk_ref(q, k0, v0, fresh, q_off, q_off - 256, sm_scale=d ** -0.5,
                                            soft_cap=cap)
        keep = (torch.arange(sq, device="cuda") % 7 == 3)[None, None]   # fresh rows
        state = tuple(torch.where(keep[..., None] if x.dim() == 4 else keep, f, x).contiguous()
                      for x, f in zip(state, fresh))
        dev = (torch.tensor(q_off, dtype=torch.int32, device="cuda"),
               torch.tensor(kv_off, dtype=torch.int32, device="cuda"))
        got = A.flash_attention_chunk(q, k, v, state, q_off, kv_off, soft_cap=cap)
        got_dev = A.flash_attention_chunk(q, k, v, state, *dev, soft_cap=cap)
        want = A.flash_attention_chunk_ref(q, k, v, state, q_off, kv_off, sm_scale=d ** -0.5,
                                           soft_cap=cap)
        torch.cuda.synchronize()
        shares = state_shares(torch, (got[2], got[0], got[1]), (want[2], want[0], want[1]))
        unseen = torch.arange(sq, device="cuda") + q_off - kv_off < 0   # rows that see no key
        kept = all(torch.equal(x[:, :, unseen], y[:, :, unseen]) for x, y in zip(got, state))
        same = all(torch.equal(x, y) for x, y in zip(got, got_dev))
        future = label == "future"
        whole = all(torch.equal(x, y) for x, y in zip(got, state)) if future else None
        emit({"phase": "kernel_case", "kernel": "flash_attention_chunk", "dtype": str(bf),
              "case": [label, f"H {h} Hkv {hk} Sq {sq} Sc {sc}", f"q_offset {q_off}",
                       f"kv_offset {kv_off}", f"soft_cap {cap}"],
              "share_of_limits": shares, "tol": STATE_TOL, "rows_unseen": int(unseen.sum()),
              "unseen_rows_bitwise": kept, "device_offsets_bitwise": same,
              "future_state_bitwise": whole,
              "ok": worst(shares) <= 1.0 and shares["same_empty"] and kept and same
              and whole is not False})
        check(shares["same_empty"] and worst(shares) <= 1.0,
              f"K8 {label}: disagrees with the plain fold: {shares}")
        check(kept, f"K8 {label}: a row with no visible key changed its state")
        check(same, f"K8 {label}: int and device offsets give different folds")
        check(whole is not False, "K8: a chunk wholly in the future changed the state")
        del q, k0, v0, k, v, state, got, got_dev, want


def phase_local_ops(tt, torch) -> tuple[dict, dict, dict]:
    """K6, K7 and K8: edge cases, then the path (counted), then each
    kernel at the main shapes against its plain version and timed.
    Returns the kernel rows and the path's launches, total and by form."""
    from triton_distributed_tpu_torch.ops import matmul as M
    from triton_distributed_tpu_torch.tune import autotuner as at

    t0 = time.perf_counter()
    phase_matmul_cases(tt, torch)
    phase_fold_cases(tt, torch)
    ins = local_inputs(tt, torch)
    path = local_ops_path(tt, torch, at, ins)
    launches, forms = path["launches"], path["forms"]
    emit({"phase": "local_ops_path",
          "launches": {k: n for k, n in launches.items() if n},
          "matmul_by_form": [[list(f), n] for (name, f), n in forms.items()
                             if name == "matmul"]})
    for label, t in path["tunes"].items():
        res = t["result"]
        emit({"phase": "fresh_tune", "shape": label, "crown": str(t["crown"]),
              "candidates_ms": {str(c): ms for c, ms in zip(t["candidates"], res.candidate_ms)},
              "winner_ms": res.time_ms, "sol_fraction": res.sol_fraction,
              "k6_launches_in_sweep": t["k6_calls"]})
        check(t["k6_calls"] > 0, f"the {label} sweep launched no K6 tile")
        a, b = ins["gemm"][label]
        check(k5_share(t["served"], M.matmul_ref(a, b), BF16_TOL, K6_RTOL) <= 1.0,
              f"the crowned backend at {label} disagrees with the plain version")
    for label, m, k, n in MATMUL_MAIN:
        want = 1
        t = path["tunes"].get(label)
        if t is not None:
            want += t["k6_calls"] + (not isinstance(t["crown"], at.LibraryBackend))
        got = forms.get(("matmul", (m, n, k)), 0)
        check(got == want, f"K6 launches at {label}: {got}, want {want}")
    check(launches["matmul"] == sum(n for (name, _), n in forms.items() if name == "matmul"),
          "K6's launches by form do not add up to its total")
    want = {"decode_attention_state": 1, "paged_decode_attention_state": 1,
            "paged_decode_attention_state_int8": 1, "flash_attention_chunk": RING}
    check(all(launches[k] == n for k, n in want.items()),
          f"K7/K8 launches {[launches[k] for k in want]}, want {list(want.values())}")
    rows = matmul_rows(tt, torch, ins, path)
    rows.update(decode_state_rows(tt, torch, ins, path))
    rows.update(fold_rows(tt, torch, ins, path))
    for row in rows.values():
        emit({"phase": "kernel_main", **{k: v for k, v in row.items() if k != "form"}})
    for row in rows.values():
        if "faulty_share_of_tol" in row:
            check(row["worst_share_of_tol"] <= 1.0,
                  f"{row['name']} disagrees with its plain version: {row['max_abs_err']}")
            check(min(row["faulty_share_of_tol"].values()) > 1.0,
                  f"{row['name']}: the limit does not reject a faulty result "
                  f"{row['faulty_share_of_tol']}")
    del ins, path
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "local_ops", "seconds": time.perf_counter() - t0})
    return rows, launches, forms


# ---------------------------------------------------------------------------
# the collectives (K9-K11) on ranks co-located on the card

H100_NVLINK_BYTES_PER_S = 450e9   # NVLink, each way, per card (not exercised here)
COLL_RANKS = (2, 3, 4, 8)
COLL_ROWS = (1, 3, 17)
COLL_WIDTHS = (8, 136, 4104, 5)   # 5: rows that are no whole 16-byte vector
COLL_TP = 4                       # Qwen3-8B served at tp = 4
COLL_WIDTH = 4096                 # Qwen3-8B's hidden size
COLL_SOURCE = "triton_distributed_tpu_torch/csrc/collectives.cu"


def pads_at_rest() -> bool:
    """Every signal pad made so far reads zero (the protocol's drains took
    every credit)."""
    from triton_distributed_tpu_torch.core import symm

    return all(int(p.data.count_nonzero()) == 0 for p in symm.signal_pads().values())


def coll_calls(torch, mesh, axis, x, xr) -> list:
    """(label, kernel thunk, plain thunk) of every method: the gather of
    ``x``, the ReduceScatter of ``xr`` (n times x's rows), and both
    AllReduces into either output dtype (one-shot on ``x``, two-shot on
    ``xr``, whose rows divide by n)."""
    from triton_distributed_tpu_torch import comm

    calls = []
    for m in list(comm.AllGatherMethod)[1:]:
        calls.append((f"all_gather/{m.value}", lambda m=m: comm.all_gather(x, mesh, axis, method=m),
                      lambda m=m: comm.all_gather_ref(x, mesh, axis, m)))
    calls.append(("reduce_scatter/ring", lambda: comm.reduce_scatter(xr, mesh, axis),
                  lambda: comm.reduce_scatter_ref(xr, mesh, axis)))
    for m, inp in ((comm.AllReduceMethod.ONE_SHOT, x), (comm.AllReduceMethod.TWO_SHOT, xr)):
        for odt in (torch.float32, torch.bfloat16):
            calls.append((f"all_reduce/{m.value}->{str(odt)[6:]}",
                          lambda m=m, inp=inp, odt=odt: comm.all_reduce(inp, mesh, axis, method=m,
                                                                       out_dtype=odt),
                          lambda m=m, inp=inp, odt=odt: comm.all_reduce_ref(inp, mesh, axis, m,
                                                                           odt)))
    return calls


def check_calls(torch, calls, what: str) -> None:
    """Each kernel call bitwise equal to its plain version on the card, and
    every pad at rest after it."""
    for label, kern, plain in calls:
        got = kern()
        want = plain()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise PhaseError(f"{what} {label}: the kernel differs from its plain version "
                             f"(max |diff| {(got.float() - want.float()).abs().max().item()})")
        check(pads_at_rest(), f"{what} {label}: a signal pad is not at rest after the call")


def phase_collective_cases(tt, torch) -> None:
    """Edge cases of K9-K11: n 2, 3, 4, 8; f32 and bf16; shards of 1, 3 and
    17 rows at widths 8, 136, 4104 and 5 (the two-shot and the ReduceScatter on
    n times the rows); every method; then three back-to-back repeats with the
    families interleaved on one mesh, and a {"dp": 2, "tp": 4} mesh."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for n in COLL_RANKS:
        mesh = make_mesh({"tp": n})
        for dt in (torch.float32, torch.bfloat16):
            for rows in COLL_ROWS:
                for w in COLL_WIDTHS:
                    calls = coll_calls(torch, mesh, "tp", rnd(n, rows, w, dtype=dt),
                                       rnd(n, n * rows, w, dtype=dt))
                    check_calls(torch, calls, f"n={n} {dt} {rows}x{w}")
                    emit({"phase": "collective_case", "n": n, "dtype": str(dt), "rows": rows,
                          "width": w, "calls": [c[0] for c in calls], "bitwise": True,
                          "pads_at_rest": True})
    # repeats, interleaved: every family three times on one mesh, no sync between
    mesh = make_mesh({"tp": 4})
    x, xr = rnd(4, 17, 4104, dtype=torch.bfloat16), rnd(4, 68, 4104, dtype=torch.bfloat16)
    calls = coll_calls(torch, mesh, "tp", x, xr)
    outs = [[kern() for _, kern, _ in calls] for _ in range(3)]
    torch.cuda.synchronize()
    for rep in outs:
        for (label, _, plain), got in zip(calls, rep):
            check(torch.equal(got, plain()), f"repeat {label}: differs from its plain version")
    check(pads_at_rest(), "a signal pad is not at rest after the interleaved repeats")
    emit({"phase": "collective_case", "repeats": 3, "interleaved": [c[0] for c in calls],
          "bitwise": True, "pads_at_rest": True})
    # two axes: each dp group gathers and reduces only its own tp ranks
    mesh = make_mesh({"dp": 2, "tp": 4})
    x, xr = rnd(2, 4, 3, 136, dtype=torch.float32), rnd(2, 4, 12, 136, dtype=torch.float32)
    check_calls(torch, coll_calls(torch, mesh, "tp", x, xr), "dp x tp")
    g = comm.all_gather(x, mesh, "tp", method=comm.AllGatherMethod.RING_BIDIR)
    s = comm.reduce_scatter(xr, mesh, "tp")
    for d in range(2):
        check(all(torch.equal(g[d, r], x[d].reshape(12, 136)) for r in range(4)),
              f"dp group {d} gathered another group's shards")
        total = xr[d].double().sum(0)
        check(all((s[d, r].double() - total[3 * r:3 * r + 3]).abs().max().item() < 1e-4
                  for r in range(4)), f"dp group {d} reduced another group's partials")
    check_calls(torch, coll_calls(torch, mesh, "dp", x, rnd(2, 4, 6, 136, dtype=torch.float32)),
                "dp x tp, over dp")
    emit({"phase": "collective_case", "mesh": {"dp": 2, "tp": 4}, "axes": ["tp", "dp"],
          "bitwise": True, "pads_at_rest": True, "groups_own_data": True})


def stalled_rank_child(kernel: str) -> int:
    """Run in a child process by phase_wait_bound: a two-rank gather (K9's
    one-way ring), AG-GEMM (K12's), K16 step, EP dispatch (K17, both
    scopes), K15's one-shot o-projection (its device-scope waits) or K11's
    one-shot (both scopes) in which rank 1 never credits its puts, so a
    wait runs out and the launch fails.  Exits non-zero through the uncaught
    error, which names the rank and the flag."""
    import torch

    from triton_distributed_tpu_torch.comm import AllGatherMethod
    from triton_distributed_tpu_torch.comm.allgather import _all_gather
    from triton_distributed_tpu_torch.core import symm
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.ops.ag_gemm import _ag_gemm

    mesh = make_mesh({"tp": 2})
    x = torch.ones(2, 4, 64, device="cuda")
    if kernel == "persistent_decode":
        import triton_distributed_tpu_torch as tt
        from triton_distributed_tpu_torch.ops import persistent_decode as PD

        c = tiny_dense(tt, torch, hidden=256, heads=8, kv_heads=4, head_dim=64, inter=512,
                       layers=1, dtype=torch.float32)
        params = tt.Qwen3(c, mesh=mesh).init(torch.Generator(device="cuda").manual_seed(1))
        cache = tt.init_paged_cache(1, 2, 4, c.max_length, 64, c.dtype, page_size=16,
                                    device="cuda", tp=2)
        PD._launch(params.embed[:2], PD.stack_decode_params(params), cache.k, cache.v,
                   cache.block_table, cache.seq_lens, mesh, "tp", rope_theta=c.rope_theta,
                   rms_eps=c.rms_eps, qk_eps=None, sm_scale=0.125, soft_cap=0.0, stall_rank=1)
    elif kernel in ("all_to_all", "all_to_all_sys"):
        from triton_distributed_tpu_torch.comm.all_to_all import AllToAllConfig, _dispatch

        splits = torch.full((2, 2), 2, dtype=torch.int32, device="cuda")
        _dispatch(x, splits, mesh, "tp", AllToAllConfig(), stall_rank=1,
                  system_scope=kernel.endswith("_sys"))
    elif kernel in ("all_reduce", "all_reduce_sys"):
        from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod, _all_reduce

        _all_reduce(x, mesh, "tp", AllReduceMethod.ONE_SHOT, torch.float32,
                    system_scope=kernel.endswith("_sys"), stall_rank=1)
    elif kernel == "ag_gemm":
        w = torch.ones(2, 64, 64, device="cuda")
        _ag_gemm(x, w, mesh, "tp", torch.float32, bidir=False, stall_rank=1)
    elif kernel == "fused_ar":
        from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod
        from triton_distributed_tpu_torch.ops.fused_decode import _launch_ar

        w = torch.ones(2, 64, 64, device="cuda")
        _launch_ar(False, x, None, w, mesh, "tp", torch.float32, AllReduceMethod.ONE_SHOT,
                   stall_rank=1)
    else:
        _all_gather(x, mesh, "tp", AllGatherMethod.RING_1D, stall_rank=1)
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"the launch failed: {e}", file=sys.stderr, flush=True)
        symm.raise_if_timed_out()
        raise
    print("the stalled launch finished", file=sys.stderr)
    return 0


STALL_KERNELS = ("all_gather", "ag_gemm", "persistent_decode", "all_to_all", "all_to_all_sys",
                 "fused_ar", "all_reduce", "all_reduce_sys")
# the (rank, flag) a stalled child must name: K16's rank 1 credits none of
# its ring puts, so rank 0 waits on its first ReduceScatter arrival, or rank
# 1, past its own ReduceScatter, on its first AllGather arrival, whichever
# wait runs out first
STALL_NAMES = {"all_gather": (("rank 0 ", "recv[1]"),), "ag_gemm": (("rank 0 ", "recv[1]"),),
               "persistent_decode": (("rank 0 ", "rs_recv[0]"), ("rank 1 ", "recv[0]")),
               # K17: rank 1 credits none of its puts, its own zone's included
               "all_to_all": (("rank 0 ", "recv[1]"), ("rank 1 ", "recv[1]")),
               "all_to_all_sys": (("rank 0 ", "recv[1]"), ("rank 1 ", "recv[1]")),
               # K15's and K11's one-shot: rank 0 waits on rank 1's push
               "fused_ar": (("rank 0 ", "recv[1]"),),
               "all_reduce": (("rank 0 ", "recv[1]"),),
               "all_reduce_sys": (("rank 0 ", "recv[1]"),)}


def phase_wait_bound(torch, kernels=STALL_KERNELS) -> None:
    """A wait cannot hang the run: each child's stalled launch (K9's gather,
    K12's AG-GEMM, K16, K17 and K11's one-shot at both scopes, K15's
    one-shot) must fail by name (STALL_NAMES) within the bounded wait, and
    this process's context carries on."""
    import subprocess

    for kernel in kernels:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--stalled-rank-child", kernel],
                             capture_output=True, text=True, timeout=300)
        text = res.stdout + res.stderr
        named = [ln for ln in text.splitlines() if "CollectiveTimeout" in ln]
        emit({"phase": "wait_bound", "kernel": kernel, "child_rc": res.returncode,
              "child_s": time.perf_counter() - t0, "named": named[-1:]})
        check(res.returncode != 0, f"the stalled {kernel} finished: a wait did not run out")
        check(bool(named) and any(rank in named[-1] and f"flag {flag}" in named[-1]
                                  for rank, flag in STALL_NAMES[kernel]),
              f"the {kernel} child did not name the stuck rank and flag:\n{text[-3000:]}")
    torch.cuda.synchronize()   # this process's context is unharmed


def coll_bytes(kind: str, n: int, p: int, po: int) -> tuple[int, int, int]:
    """(the function's bytes, the schedule's bytes, the bytes one rank sends
    to its peers) of one call over all n co-located ranks; ``p`` is a rank's
    input in bytes, ``po`` its output (AllReduce) or 0.

    The function's bytes are the bound's: every rank's input read once and
    every rank's output written once (a gather's n shards, a ReduceScatter's
    one chunk, an AllReduce's whole sum).  The schedule's bytes add every
    landing write and read the design needs: a gather writes n chunks a rank
    and (rings) reads each chunk it forwards; the ReduceScatter ring writes
    and reads n - 1 slots a rank; the one-shot writes and reads n - 1 slots a
    rank (its own partial is summed from x in place); the two-shot does the
    ring, then writes n and forwards n - 1 out-chunks a rank."""
    c = p // n
    if kind in ("push", "ring", "bidir"):
        fn = n * p + n * n * p
        sched = fn if kind == "push" else fn + n * (n - 1) * p
        return fn, sched, (n - 1) * p
    if kind == "rs":
        return n * p + n * c, n * p + 2 * n * (n - 1) * c + n * c, (n - 1) * c
    fn = n * p + n * po
    if kind == "one_shot":
        return fn, n * p + 2 * n * (n - 1) * p + n * po, (n - 1) * p
    co = po // n
    return fn, n * (p + 2 * (n - 1) * c + (2 * n - 1) * co), (n - 1) * (c + co)


def collective_main_rows(tt, torch) -> tuple[dict, dict, dict]:
    """K9-K11 at Qwen3-8B's width under tp = 4 (B = 4, prompts of 1024), bf16:
    the path (each row once, counted), then each row held bitwise to its
    plain version and timed beside its bound, the plain version and one
    PyTorch call computing the same rank-stacked result."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func

    n, w, bf = COLL_TP, COLL_WIDTH, torch.bfloat16
    mesh = make_mesh({"tp": n})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    x_pre, x_dec = rnd(n, BATCH * PROMPT // n, w), rnd(n, 1, w)
    x_part, x_ar1 = rnd(n, BATCH * PROMPT, w), rnd(n, BATCH, w)
    # (name, kind, x, kernel, plain, (library label, call), replaces, counter, form, po)
    specs = []
    for x in (x_pre, x_dec):
        label = f"{x.shape[1]}x{w}"
        for kind, m, line in (("push", comm.AllGatherMethod.PUSH_1SHOT, 80),
                              ("ring", comm.AllGatherMethod.RING_1D, 107),
                              ("bidir", comm.AllGatherMethod.RING_BIDIR, 121)):
            specs.append((f"all_gather[{m.value} {label}]", kind, x,
                          lambda x=x, m=m: comm.all_gather(x, mesh, "tp", method=m),
                          lambda x=x, m=m: comm.all_gather_ref(x, mesh, "tp", m),
                          ("expand(...).contiguous()",
                           lambda x=x: x.reshape(1, -1, w).expand(n, -1, w).contiguous()),
                          f"triton_distributed_tpu/comm/allgather.py:{line}", "all_gather",
                          (m.value, n, tuple(x.shape[1:])), 0))
    # sum(0) over the stacked partials is (M, w), rank r's chunk at rows r M / n:
    # the rank-stacked result itself
    specs.append((f"reduce_scatter[ring {x_part.shape[1]}x{w}]", "rs", x_part,
                  lambda: comm.reduce_scatter(x_part, mesh, "tp"),
                  lambda: comm.reduce_scatter_ref(x_part, mesh, "tp"),
                  ("sum(0)", lambda: x_part.sum(0)),
                  "triton_distributed_tpu/comm/reduce_scatter.py:50",
                  "reduce_scatter", ("ring", n, tuple(x_part.shape[1:])), 0))
    for kind, m, x, line in (("one_shot", comm.AllReduceMethod.ONE_SHOT, x_ar1, 89),
                             ("two_shot", comm.AllReduceMethod.TWO_SHOT, x_part, 131)):
        specs.append((f"all_reduce[{m.value} {x.shape[1]}x{w}]", kind, x,
                      lambda x=x, m=m: comm.all_reduce(x, mesh, "tp", method=m, out_dtype=bf),
                      lambda x=x, m=m: comm.all_reduce_ref(x, mesh, "tp", m, bf),
                      ("sum(0, keepdim=True).expand(n, ...).contiguous()",
                       lambda x=x: x.sum(0, keepdim=True).expand(n, -1, -1).contiguous()),
                      f"triton_distributed_tpu/comm/allreduce.py:{line}",
                      "all_reduce", (m.value, n, tuple(x.shape[1:])), x[0].numel() * 2))
    # the path: every row once, through the kernels, counted
    torch.cuda.synchronize()
    tt.reset_launch_counts()
    outs = {s[0]: s[3]() for s in specs}
    torch.cuda.synchronize()
    launches, forms = tt.launch_counts(), tt.launch_forms()
    check(pads_at_rest(), "a signal pad is not at rest after the collectives' path")
    rows = {}
    for name, kind, x, kern, plain, (library, lib), replaces, counter, form, po in specs:
        want = plain()
        got = outs.pop(name)
        check(torch.equal(got, want), f"{name}: the kernel differs from its plain version")
        check(lib().numel() == got.numel(),
              f"{name}: the library call writes another number of elements")
        del got, want
        _, ms = perf_func(kern, iters=20)
        _, plain_ms = perf_func(plain, iters=3)
        _, lib_ms = perf_func(lib, iters=20)
        p = x[0].numel() * x.element_size()
        fn_bytes, sched_bytes, sent = coll_bytes(kind, n, p, po)
        rows[name] = dict(
            name=name, route="cuda", source=COLL_SOURCE, replaces=replaces, max_abs_err=0.0,
            ms=ms, plain_ms=plain_ms, bound_ms=fn_bytes / H100_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=lib_ms, library=library,
            function_bytes=fn_bytes, schedule_bytes=sched_bytes,
            schedule_bound_ms=sched_bytes / H100_BYTES_PER_S * 1e3,
            nvlink_bound_ms=sent / H100_NVLINK_BYTES_PER_S * 1e3,
            nvlink_bound="not measured: a rank's sent bytes over 450 GB/s each way across "
                         "four cards; co-located ranks exchange through device memory",
            rank_sent_bytes=sent, shape=f"{tuple(x.shape)} bf16", counter=counter, form=form)
        gc.collect()
    check(pads_at_rest(), "a signal pad is not at rest after the timed calls")
    return rows, launches, forms


def k11_system_scope(torch) -> None:
    """K11's one-shot in its system-scope form (kept for the multi-card
    host: the entry barrier, system-scope flags) at the main row's shape, 4 x
    4096 bf16 at n = 4: bitwise the plain version (the slot-order f32 sum),
    like the device-scope form, every pad at rest after each; both timed in
    turns (a kernel_main line; no path runs the system-scope form, so it is
    not in the kernels line)."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.allreduce import _all_reduce
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    n, w, bf = COLL_TP, COLL_WIDTH, torch.bfloat16
    mesh = make_mesh({"tp": n})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    x = torch.randn((n, BATCH, w), generator=gen, device="cuda").to(bf)
    one = comm.AllReduceMethod.ONE_SHOT
    forms = {"device": lambda: _all_reduce(x, mesh, "tp", one, bf),
             "system": lambda: _all_reduce(x, mesh, "tp", one, bf, system_scope=True)}
    want = comm.all_reduce_ref(x, mesh, "tp", one, bf)
    for scope, fn in forms.items():
        got = fn()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K11 one-shot, {scope} scope: differs from the plain "
                                      "version")
        check(pads_at_rest(), f"K11 one-shot, {scope} scope: a signal pad is not at rest")
    ms = interleaved_ms(torch, forms)
    emit({"phase": "kernel_main", "name": f"all_reduce[one_shot {BATCH}x{w}, system scope]",
          "ms": ms["system"], "device_scope_ms": ms["device"], "bitwise": True,
          "pads_at_rest": True, "timed": "in turns, median of 5 rounds of 10 calls"})


def k9_system_scope(torch) -> None:
    """K9's system-scope form (kept for the multi-card host: the push's hub
    barrier and the rings' neighbours' barrier, system-scope flags, lanes of
    at least two units a thread) at the main rows' shapes, 1 x 4096 and
    1024 x 4096 bf16 a rank at n = 4, each form: bitwise the plain version,
    like the device-scope form, every pad at rest after each; both timed in
    turns (kernel_main lines; no path runs the system-scope form, so it is
    not in the kernels line)."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.allgather import _all_gather
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    n, w, bf = COLL_TP, COLL_WIDTH, torch.bfloat16
    mesh = make_mesh({"tp": n})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    for rows in (1, BATCH * PROMPT // n):
        x = torch.randn((n, rows, w), generator=gen, device="cuda").to(bf)
        for m in list(comm.AllGatherMethod)[1:]:
            forms = {"device": lambda m=m: _all_gather(x, mesh, "tp", m, -1),
                     "system": lambda m=m: _all_gather(x, mesh, "tp", m, -1, system_scope=True)}
            want = comm.all_gather_ref(x, mesh, "tp", m)
            for scope, fn in forms.items():
                got = fn()
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"K9 {m.value} {rows}x{w}, {scope} scope: differs "
                                              "from the plain version")
                check(pads_at_rest(), f"K9 {m.value} {rows}x{w}, {scope} scope: a signal pad is "
                                      "not at rest")
            ms = interleaved_ms(torch, forms)
            emit({"phase": "kernel_main", "name": f"all_gather[{m.value} {rows}x{w}, system scope]",
                  "ms": ms["system"], "device_scope_ms": ms["device"], "bitwise": True,
                  "pads_at_rest": True, "timed": "in turns, median of 5 rounds of 10 calls"})


def phase_collectives(tt, torch) -> tuple[dict, dict, dict]:
    """K9-K11: edge cases, the timeout child, then the main rows (counted and
    timed), K9 and K11's one-shot at system scope.  Returns the kernel rows
    and the path's launches, total and by form."""
    t0 = time.perf_counter()
    phase_collective_cases(tt, torch)
    phase_wait_bound(torch)
    rows, launches, forms = collective_main_rows(tt, torch)
    k9_system_scope(torch)
    k11_system_scope(torch)
    emit({"phase": "collectives_path",
          "launches": {k: v for k, v in launches.items() if v},
          "by_form": [[name, list(f), v] for (name, f), v in forms.items()]})
    for row in rows.values():
        emit({"phase": "kernel_main", **{k: v for k, v in row.items() if k != "form"}})
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "collectives", "seconds": time.perf_counter() - t0})
    return rows, launches, forms


# ---------------------------------------------------------------------------
# the overlapped GEMMs (K12-K14) on ranks co-located on the card

OVERLAP_SOURCE = "triton_distributed_tpu_torch/csrc/overlap_gemm.cu"
OVERLAP_RANKS = (2, 3, 4)
# (m_loc, K, N of one rank's product): rows off the tile (1, 37, 130), K and N
# multiples of 8 off the tile (136, 200, 264, 1032)
OVERLAP_SHAPES = ((1, 136, 136), (37, 264, 200), (130, 1032, 264))
# (operand, output) dtypes the kernels are built for
OVERLAP_DTYPES = (("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"))
F32_UNIT = 2.0 ** -24
# each planted fault must land at least this many limits from the plain
# version at its worst element
FAULT_MARGIN = 10.0


def overlap_limit(torch, abs_sum, k: int, values, out_dtype):
    """The per-element limit of |kernel - plain| for an overlapped GEMM.
    ``abs_sum``: the sum of |A_r| @ |B_r| over the partial products that
    reach the element; ``values``: the sum of |x| over every value the plain
    version rounds to the output dtype on the way to it (each partial
    product, and the partial sum after each ring hop), in f32.  Both sides
    accumulate each length-k dot in f32 in their own order, each within
    k 2**-24 abs_sum of the exact value; the ring then adds the same values
    in the same order, and each rounding (unit u: 2**-8 for bf16, 2**-24 for
    f32) moves the two sides at most u (|x| + |x'|) further apart: 2 u |x|
    to first order, and the factor 1 + 2**-5 holds the second."""
    u = 2.0 ** -8 if out_dtype == torch.bfloat16 else F32_UNIT
    return 2 * k * F32_UNIT * abs_sum + 2 * u * (1 + 2.0 ** -5) * values


def ring_hop_sums(torch, parts):
    """For every output chunk c of the ReduceScatter ring, the sum over its
    hops of |the partial sum after the hop|, in f32 (``comm/ring.py::
    rs_ring_phase``: chunk c's sum starts at rank c + 1 and travels right,
    its last add at rank c).  ``parts`` (n, M, N): each rank's partial
    product.  Returns (n, M / n, N), chunk c at index c."""
    n = parts.shape[0]
    chunks = parts.reshape(n, n, -1, parts.shape[-1])    # [rank, chunk, rows, N]
    sums = []
    for c in range(n):
        acc, tot = chunks[(c + 1) % n, c], 0
        for i in range(2, n + 1):
            acc = acc + chunks[(c + i) % n, c]
            tot = tot + acc.abs()
        sums.append(tot)
    return torch.stack(sums)


def ag_check(torch, gathered, b, out_dtype):
    """(limit, faults) of K12 on the gathered A: one product per element, no
    hop.  The fault: each rank's C with chunk 0's rows taken from chunk 1
    (a chunk of another rank)."""
    g, w = gathered.float(), b.float()
    limit = overlap_limit(torch, torch.matmul(g.abs(), w.abs()), g.shape[-1],
                          torch.matmul(g, w).abs(), out_dtype)
    m_loc = g.shape[-2] // g.shape[0]

    def faults(got):
        other = got.clone()
        other[:, :m_loc] = got[:, m_loc:2 * m_loc]
        return {"chunk_of_another_rank": other}

    return limit, faults


def rs_check(torch, a, b, out_dtype, replicated: bool):
    """(limit, faults) of K13 (``replicated`` False: rank c holds chunk c)
    or K14 (every rank holds every chunk) on rank-stacked a (n, M, k_loc),
    b (n, k_loc, N).  The faults: rank 0's partial product left out, and
    chunk 0 taken from chunk 1 (a chunk of another rank)."""
    n, m, k = a.shape
    parts = torch.matmul(a.float(), b.float())                    # (n, M, N)
    abs_sum = torch.matmul(a.float().abs(), b.float().abs()).sum(0)
    values = parts.abs().sum(0).reshape(n, m // n, -1) + ring_hop_sums(torch, parts)
    abs_sum = abs_sum.reshape(n, m // n, -1)
    left_out = parts[0].reshape(n, m // n, -1)
    if replicated:
        abs_sum, values, left_out = (t.reshape(1, m, -1).expand(n, -1, -1)
                                     for t in (abs_sum, values, left_out))
    limit = overlap_limit(torch, abs_sum, k, values, out_dtype)

    def faults(got):
        other = got.clone()
        if replicated:
            other[:, :m // n] = got[:, m // n:2 * m // n]
        else:
            other[0] = got[1]
        return {"partial_left_out": got.float() - left_out, "chunk_of_another_rank": other}

    return limit, faults


def overlap_share(torch, got, want, limit) -> float:
    """The largest |got - want| as a share of its element's limit (0 where
    both are exact zeros)."""
    err = (got.float() - want.float()).abs()
    return float((err / limit.clamp_min(1e-30)).max()) if err.numel() else 0.0


def rotating(calls):
    """A thunk that runs ``calls`` in turn, one a call (the same kernel on
    weight copies that together exceed the L2, for a cold-weight time)."""
    turn = [0]

    def thunk():
        turn[0] = (turn[0] + 1) % len(calls)
        return calls[turn[0]]()

    return thunk


def overlap_calls(torch, mesh, a, b, a_rs, b_rs, out_dtype) -> list:
    """(label, kernel thunk, plain thunk, chain thunk, limit, faults) of
    every overlapped GEMM on these operands: K12 both rings (C and the
    gathered A), K13 and K14 in both forms, each forced through the private
    entry.  The chains: K9 then K12/K13's main loop alone (the rank-stacked
    product of ``comm/launch.py::loop_product``); that loop then K10; K14's
    ring loop alone (``ring_loop_product``, gemm_tile.cuh's tiles) then
    K11's two-shot; for K14's one-shot, the slot-order f32 sum of the
    kernel's own rounded partials (its product entries, read back), so
    "bitwise to its chain" holds its exchange."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.launch import loop_product, ring_loop_product
    from triton_distributed_tpu_torch.ops import ag_gemm as AG
    from triton_distributed_tpu_torch.ops import gemm_ar as AR
    from triton_distributed_tpu_torch.ops import gemm_rs as RS

    n = mesh.shape["tp"]

    def ag_chain(m):
        g = comm.all_gather(a, mesh, method=m)
        return loop_product(g, b, out_dtype), g

    calls = []
    ag = ag_check(torch, comm.all_gather_ref(a, mesh), b, out_dtype)
    for bidir, m in ((False, comm.AllGatherMethod.RING_1D), (True, comm.AllGatherMethod.RING_BIDIR)):
        calls.append((f"ag_gemm/{'bidir' if bidir else 'unidir'}",
                      lambda bidir=bidir: AG.ag_gemm(a, b, mesh, out_dtype=out_dtype,
                                                     return_gathered=True, bidir=bidir),
                      lambda bidir=bidir: AG.ag_gemm_ref(a, b, mesh, out_dtype=out_dtype,
                                                         bidir=bidir),
                      lambda m=m: ag_chain(m), *ag))
    calls.append(("gemm_rs/ring", lambda: RS.gemm_rs(a_rs, b_rs, mesh, out_dtype=out_dtype),
                  lambda: RS.gemm_rs_ref(a_rs, b_rs, mesh, out_dtype=out_dtype),
                  lambda: comm.reduce_scatter(loop_product(a_rs, b_rs, out_dtype), mesh),
                  *rs_check(torch, a_rs, b_rs, out_dtype, replicated=False)))
    ring, one = comm.AllReduceMethod.TWO_SHOT, comm.AllReduceMethod.ONE_SHOT
    calls.append(("gemm_ar/ring", lambda: AR._gemm_ar(a_rs, b_rs, mesh, "tp", out_dtype, ring),
                  lambda: AR.gemm_ar_ref(a_rs, b_rs, mesh, out_dtype=out_dtype, method=ring),
                  lambda: comm.all_reduce(ring_loop_product(a_rs, b_rs, out_dtype), mesh,
                                          method=ring),
                  *rs_check(torch, a_rs, b_rs, out_dtype, replicated=True)))
    m, cols = a_rs.shape[-2], b_rs.shape[-1]
    calls.append(("gemm_ar/one_shot", lambda: AR._gemm_ar(a_rs, b_rs, mesh, "tp", out_dtype, one),
                  lambda: AR.gemm_ar_ref(a_rs, b_rs, mesh, out_dtype=out_dtype, method=one),
                  lambda: slot_sum(torch, own_partials(torch, mesh, m, cols, out_dtype),
                                   out_dtype).expand(n, -1, -1),
                  *oneshot_check(torch, a_rs.float(), b_rs.float(), out_dtype, mesh)))
    return calls


def check_overlap_calls(torch, calls, what: str) -> tuple[dict, dict]:
    """Each call: equal bitwise to its chain, within its limit of its plain
    version (the gathered A bitwise), every pad at rest after it; each
    planted fault at least FAULT_MARGIN limits from the plain version.
    Returns the worst share of the limit per call, and the least share of
    the limit per planted fault."""
    shares, faulty = {}, {}
    for label, kern, plain, chain, limit, faults in calls:
        got, want, link = kern(), plain(), chain()
        if isinstance(got, tuple):   # K12: (C, gathered)
            check(torch.equal(got[1], want[1]) and torch.equal(got[1], link[1]),
                  f"{what} {label}: the gathered A differs")
            got, want, link = got[0], want[0], link[0]
        torch.cuda.synchronize()
        check(pads_at_rest(), f"{what} {label}: a signal pad is not at rest after the call")
        if got.dtype != link.dtype or not torch.equal(got, link):
            raise PhaseError(f"{what} {label}: the kernel differs from its chain (max |diff| "
                             f"{(got.float() - link.float()).abs().max().item()})")
        shares[label] = overlap_share(torch, got, want, limit)
        check(shares[label] <= 1.0, f"{what} {label}: the kernel is {shares[label]:.3g} of its "
                                    f"limit from its plain version")
        for fault, bad in faults(got).items():
            faulty[f"{label}/{fault}"] = share = overlap_share(torch, bad, want, limit)
            check(share >= FAULT_MARGIN, f"{what} {label}: the planted fault {fault} is only "
                                         f"{share:.3g} of the limit from the plain version")
    return shares, faulty


def phase_overlap_cases(tt, torch) -> None:
    """Edge cases of K12-K14: n 2, 3, 4; f32, bf16 and bf16 -> f32; a rank's
    product of 1, 37 and 130 rows by K 136-1032 by N 136-264 (off the tile
    on every edge); both rings of K12 with the gathered A; each call bitwise
    equal to its chain, within the stated limit of its plain version, every
    pad at rest; then three interleaved repeats with no sync between."""
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def operands(n, m_loc, k, cols, dt):
        # unit-variance activations and weights of variance 1 / K, so the
        # products are O(1) at any K
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

        a, b = rnd(n, m_loc, k), rnd(n, k, cols, scale=k ** -0.5)
        a_rs, b_rs = rnd(n, n * m_loc, k), rnd(n, k, cols, scale=(n * k) ** -0.5)
        return a, b, a_rs, b_rs

    for n in OVERLAP_RANKS:
        mesh = make_mesh({"tp": n})
        for dt, odt in OVERLAP_DTYPES:
            for m_loc, k, cols in OVERLAP_SHAPES:
                calls = overlap_calls(torch, mesh, *operands(n, m_loc, k, cols, dts[dt]), dts[odt])
                shares, faulty = check_overlap_calls(torch, calls, f"n={n} {dt}->{odt} "
                                                     f"{m_loc}x{k}x{cols}")
                emit({"phase": "overlap_case", "n": n, "dtype": f"{dt}->{odt}",
                      "m_loc_k_n": [m_loc, k, cols], "chain_bitwise": True,
                      "gathered_bitwise": True, "pads_at_rest": True,
                      "worst_share_of_limit": shares, "faulty_share_of_limit": faulty})
    mesh = make_mesh({"tp": 4})
    calls = overlap_calls(torch, mesh, *operands(4, 37, 264, 200, torch.bfloat16), torch.bfloat16)
    outs = [[kern() for _, kern, *_ in calls] for _ in range(3)]
    torch.cuda.synchronize()
    for rep in outs:
        for (label, _, _, chain, *_), got in zip(calls, rep):
            got, link = (got[0], chain()[0]) if isinstance(got, tuple) else (got, chain())
            check(torch.equal(got, link), f"repeat {label}: differs from its chain")
    check(pads_at_rest(), "a signal pad is not at rest after the interleaved repeats")
    emit({"phase": "overlap_case", "repeats": 3, "interleaved": [c[0] for c in calls],
          "chain_bitwise": True, "pads_at_rest": True})


# Qwen3-8B at tp = 4, B = 4 x 1024 (prefill) and B = 4 (decode): (name, K#,
# kind, rows M, K, N of the whole product, replaces)
OVERLAP_MAIN = (
    ("ag_gemm[qkv]", "ag_gemm", BATCH * PROMPT, 4096, 6144,
     "triton_distributed_tpu/ops/ag_gemm.py:123"),
    ("ag_gemm[gate_up]", "ag_gemm", BATCH * PROMPT, 4096, 24576,
     "triton_distributed_tpu/ops/ag_gemm.py:123"),
    ("gemm_rs[o]", "gemm_rs", BATCH * PROMPT, 4096, 4096,
     "triton_distributed_tpu/ops/gemm_rs.py:57"),
    ("gemm_rs[down]", "gemm_rs", BATCH * PROMPT, 12288, 4096,
     "triton_distributed_tpu/ops/gemm_rs.py:57"),
    ("gemm_ar[o decode]", "gemm_ar", BATCH, 4096, 4096,
     "triton_distributed_tpu/ops/gemm_ar.py:59"),
    ("gemm_ar[down decode]", "gemm_ar", BATCH, 12288, 4096,
     "triton_distributed_tpu/ops/gemm_ar.py:59"),
)


def overlap_form(kind: str, n: int, m: int, k: int, cols: int) -> tuple:
    """The launch counter's form of a main row (ops/*.py count()): K14's at
    decode is the one-shot."""
    if kind == "ag_gemm":
        return ("bidir", n, (m // n, k), (k, cols // n))
    return ("one_shot" if kind == "gemm_ar" else "ring", n, (m, k // n), (k // n, cols))


def overlap_main_rows(tt, torch) -> dict:
    """K12-K14 at the Qwen3-8B tp = 4 shapes, bf16: each against its chain
    (bitwise; K14, whose decode rows run the one-shot form, within the
    limit of its chain and bitwise the slot-order sum of its own partials,
    with its planted faults) and its plain version (within the limit),
    timed beside its bound (obs/costs.py's operations over all ranks, the
    function's bytes), its plain version, its chain and one torch.matmul of
    the whole unsharded product (the work the ranks do together).  K14's
    ring form is forced through the private entry at the same shapes, held
    bitwise to its chain and within its limit, and timed in turns with the
    one-shot (``ring_ms``); at the o-projection, whose weights fit in the
    L2, both are also timed cycling through four weight copies."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.launch import loop_product, ring_loop_product
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.obs import costs
    from triton_distributed_tpu_torch.ops import ag_gemm as AG
    from triton_distributed_tpu_torch.ops import gemm_ar as AR
    from triton_distributed_tpu_torch.ops import gemm_rs as RS
    from triton_distributed_tpu_torch.ops.matmul import DEFAULT_TILES, matmul

    n, bf = COLL_TP, torch.bfloat16
    one, ring = comm.AllReduceMethod.ONE_SHOT, comm.AllReduceMethod.TWO_SHOT
    mesh = make_mesh({"tp": n})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    rows = {}
    for name, kind, m, k, cols, replaces in OVERLAP_MAIN:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

        def k6(x, w):   # K6 per rank at its default tile
            return torch.stack([matmul(x[r], w[r], config=DEFAULT_TILES[bf]) for r in range(n)])

        if kind == "ag_gemm":
            a, b = rnd(n, m // n, k), rnd(n, k, cols // n, scale=k ** -0.5)
            kern = lambda a=a, b=b: AG.ag_gemm(a, b, mesh)
            plain = lambda a=a, b=b: AG.ag_gemm_ref(a, b, mesh, bidir=True)[0]
            chain = lambda a=a, b=b: loop_product(comm.all_gather(
                a, mesh, method=comm.AllGatherMethod.RING_BIDIR), b)
            whole = (a.reshape(m, k), b.permute(1, 0, 2).reshape(k, cols))
            limit, _ = ag_check(torch, comm.all_gather_ref(a, mesh), b, bf)
            cost = costs.ag_gemm(m // n, k, cols // n, n, bf)
            # every rank's shard and weight read once; C and the gathered A
            # (each rank's copy) written once
            fn_bytes = nbytes(a, b) + m * cols * 2 + n * m * k * 2
        else:
            a, b = rnd(n, m, k // n), rnd(n, k // n, cols, scale=k ** -0.5)
            op, ref = ((RS.gemm_rs, RS.gemm_rs_ref) if kind == "gemm_rs"
                       else (AR.gemm_ar, AR.gemm_ar_ref))
            kern = lambda a=a, b=b, op=op: op(a, b, mesh)
            plain = lambda a=a, b=b, ref=ref: ref(a, b, mesh)
            if kind == "gemm_rs":
                chain = lambda a=a, b=b: comm.reduce_scatter(loop_product(a, b), mesh)
                limit, _ = rs_check(torch, a, b, bf, replicated=False)
            else:
                # the chain the "ar" path runs: K6 per rank, then K11 by its
                # size rule (the one-shot here)
                chain = lambda a=a, b=b: comm.all_reduce(k6(a, b), mesh)
                limit, faults = oneshot_check(torch, a.float(), b.float(), bf, mesh)
            whole = (a.permute(1, 0, 2).reshape(m, k), b.reshape(k, cols))
            cost = getattr(costs, kind)(m // n, k // n, cols, n, bf,
                                        **({"one_shot": True} if kind == "gemm_ar" else {}))
            out_rows = m // n if kind == "gemm_rs" else m
            fn_bytes = nbytes(a, b) + n * out_rows * cols * 2
        extra = {}
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if kind == "gemm_ar":
            check(AR._method(a, b, mesh, "tp", bf, comm.AllReduceMethod.AUTO) == one,
                  f"{name}: the size rule did not pick the one-shot at decode")
            check_own_reduction(torch, mesh, got, bf, name)
            bad = {key: overlap_share(torch, t, want, limit) for key, t in faults(got).items()}
            for key, v in bad.items():
                check(v >= FAULT_MARGIN, f"{name}: the planted fault {key} is only {v:.3g} "
                                         "of the limit from the plain version")
            link = chain()
            extra.update(reduction_bitwise=True, faulty_share_of_limit=bad,
                         worst_share_vs_chain=overlap_share(torch, got, link, limit))
            check(extra["worst_share_vs_chain"] <= 1.0, f"{name}: beyond its limit of its chain")
            # the ring form, forced: bitwise its chain (its loop alone then
            # K11's two-shot), within its limit of its plain version
            ring_kern = lambda a=a, b=b: AR._gemm_ar(a, b, mesh, "tp", bf, ring)  # noqa: E731
            got_r, want_r = ring_kern(), AR.gemm_ar_ref(a, b, mesh, method=ring)
            link_r = comm.all_reduce(ring_loop_product(a, b), mesh, method=ring)
            torch.cuda.synchronize()
            check(torch.equal(got_r, link_r), f"{name}: the ring form differs from its chain")
            r_limit, _ = rs_check(torch, a, b, bf, replicated=True)
            extra["ring_worst_share_of_limit"] = overlap_share(torch, got_r, want_r, r_limit)
            check(extra["ring_worst_share_of_limit"] <= 1.0,
                  f"{name}: the ring form is beyond its limit of its plain version")
            del got_r, want_r, link_r, r_limit
        else:
            link = chain()
            torch.cuda.synchronize()
            check(torch.equal(got, link), f"{name}: the kernel differs from its chain")
        share = overlap_share(torch, got, want, limit)
        check(share <= 1.0, f"{name}: {share:.3g} of its limit from its plain version")
        check(pads_at_rest(), f"{name}: a signal pad is not at rest after the call")
        err = (got.float() - want.float()).abs().max().item()
        del got, want, link, limit
        if kind == "gemm_ar":
            # the one-shot and the ring in turns: one-shot, ring, ring, one-shot
            t = [perf_func(fn, iters=20)[1] for fn in (kern, ring_kern, ring_kern, kern)]
            ms = (t[0] + t[3]) / 2
            extra.update(ring_ms=(t[1] + t[2]) / 2, ms_runs=[t[0], t[3]],
                         ring_ms_runs=[t[1], t[2]])
            if b.numel() * 2 < 50e6:   # the ranks' weights fit in the L2: also cold
                bs = [b] + [b.clone() for _ in range(3)]
                cold = (rotating([lambda w=w, a=a: AR.gemm_ar(a, w, mesh) for w in bs]),
                        rotating([lambda w=w, a=a: AR._gemm_ar(a, w, mesh, "tp", bf, ring)
                                  for w in bs]))
                t = [perf_func(fn, iters=20)[1] for fn in (cold[0], cold[1], cold[1], cold[0])]
                extra.update(ms_rotating_weights=(t[0] + t[3]) / 2,
                             ring_ms_rotating_weights=(t[1] + t[2]) / 2)
                del bs, cold
        else:
            _, ms = perf_func(kern, iters=20)
        _, plain_ms = perf_func(plain, iters=3)
        _, chain_ms = perf_func(chain, iters=20)
        _, lib_ms = perf_func(lambda w=whole: torch.matmul(*w), iters=20)
        if kind == "ag_gemm":   # the chain of PRs 6-10, on K6 (its default tile)
            k6_chain = lambda a=a, b=b: k6(comm.all_gather(  # noqa: E731
                a, mesh, method=comm.AllGatherMethod.RING_BIDIR), b)
        elif kind == "gemm_rs":
            k6_chain = lambda a=a, b=b: comm.reduce_scatter(k6(a, b), mesh)  # noqa: E731
        if kind != "gemm_ar":
            extra["k6_chain_ms"] = perf_func(k6_chain, iters=20)[1]
        flops = n * cost.flops
        bound_ms, bound_by = bound(flops, fn_bytes, H100_BF16_FLOPS)
        rows[name] = dict(
            name=name, route="cuda", source=(FUSED_AR_SOURCE if kind == "gemm_ar"
                                             else OVERLAP_SOURCE), replaces=replaces,
            max_abs_err=err, worst_share_of_limit=share, ms=ms, **extra, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            library="torch.matmul of the whole unsharded product", chain_ms=chain_ms,
            chain={"ag_gemm": "K9 two-way ring then the new loop over the ranks",
                   "gemm_rs": "the new loop over the ranks then K10",
                   "gemm_ar": "K6 per rank then K11 (one-shot)"}[kind],
            flops=flops, function_bytes=fn_bytes, shape=f"n={n} M={m} K={k} N={cols} bf16",
            counter=kind, form=overlap_form(kind, n, m, k, cols))
        del a, b, whole
        gc.collect()
    check(pads_at_rest(), "a signal pad is not at rest after the overlapped GEMMs' rows")
    return rows


def loop_main_rows(tt, torch) -> None:
    """K12's and K13's main loop alone (``comm/launch.py::loop_product``,
    csrc/wgmma_tile.cuh) at the four whole Qwen3-8B tp = 4 prefill products,
    bf16, held to K6's limit of the plain product (BF16_TOL + K6_RTOL
    |plain|) and timed beside the bound, torch.matmul and K6 at its default
    tile: the loop's share of K12/K13's time, apart from the scaffold's.
    Printed as kernel_main lines; the loop is no kernel of the path (no
    launch counter), so it is not in the kernels line."""
    from triton_distributed_tpu_torch.comm.launch import loop_product
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops.matmul import DEFAULT_TILES, matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
    atol, rtol = k6_limits(torch, torch.bfloat16)
    for label, m, k, n in MATMUL_MAIN[2:6]:
        a, b = k6_operands(torch, gen, m, k, n, torch.bfloat16)
        x, w = a.unsqueeze(0), b.unsqueeze(0)
        got = loop_product(x, w)[0]
        want = torch.matmul(a.float(), b.float())
        share = k5_share(got, want, atol, rtol)
        check(share <= 1.0, f"the new loop at {label}: {share:.3g} of K6's limit")
        t = interleaved_ms(torch, {"loop": lambda: loop_product(x, w),
                                   "library": lambda: torch.matmul(a, b),
                                   "k6": lambda: matmul(a, b, config=DEFAULT_TILES[a.dtype])})
        bound_ms, bound_by = bound(2 * m * k * n, nbytes(a, b) + m * n * 2, H100_BF16_FLOPS)
        emit({"phase": "kernel_main", "name": f"wgmma_loop[{label}]", "route": "cuda",
              "source": "triton_distributed_tpu_torch/csrc/wgmma_tile.cuh",
              "max_abs_err": (got.float() - want).abs().max().item(),
              "worst_share_of_tol": share, "ms": t["loop"], "library_ms": t["library"],
              "k6_ms": t["k6"], "bound_ms": bound_ms, "bound_by": bound_by,
              "loop_over_library": t["loop"] / t["library"], "shape": f"{m}x{k}x{n} bf16"})
        del a, b, x, w, got, want
    gc.collect()


def phase_overlap(tt, torch) -> dict:
    """K12-K14: edge cases, the new loop alone, then the main rows (their
    launches are read from the serve_tp path)."""
    t0 = time.perf_counter()
    phase_overlap_cases(tt, torch)
    loop_main_rows(tt, torch)
    rows = overlap_main_rows(tt, torch)
    for row in rows.values():
        emit({"phase": "kernel_main", **{k: v for k, v in row.items() if k != "form"}})
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "overlap", "seconds": time.perf_counter() - t0})
    return rows


# ---------------------------------------------------------------------------
# K15 (the fused GEMM + AllReduce ring), K4 rank-folded, K16 (the
# persistent decode kernel)

FUSED_AR_SOURCE = "triton_distributed_tpu_torch/csrc/fused_ar.cu"
# K16's served form (bf16, head dim 128)
PERSISTENT_SOURCE = "triton_distributed_tpu_torch/csrc/persistent_decode_v2.cu"
FUSED_SOURCE = "triton_distributed_tpu_torch/csrc/fused_decode.cu"
FUSED_AR_ROWS = (1, 3, 4, 5)
# (K, F / n, N / n): off the 64-column tile and the 64-row K granule
FUSED_AR_SHAPES = ((200, 40, 24), (1032, 264, 136))
# K16's stated limits of |kernel - plain| per element: tol_rms * rms(the
# plain row) + tol_rel * |plain|.  f32: the two sum in other orders only.
# bf16: a rounding that flips (an ulp, 2**-8 of the value rounded, each
# side) in any of a layer's products, norms or adds moves the residual
# stream by about one bf16 ulp of the row, and the layers add theirs up;
# the appended K/V of layer l come from the residual stream after l - 1
# layers, so they carry the same error as x.  (On an H100 a two-layer
# step's pools reached 1.13 of (2**-6, 2**-7), and x 0.33 of (2**-5, 2**-6)
# after one layer: hence (2**-4, 2**-5) for both.)
PERSISTENT_TOL = {"float32": {"x": (1e-4, 1e-4), "pool": (1e-4, 1e-4)},
                  "bfloat16": {"x": (2.0 ** -4, 2.0 ** -5), "pool": (2.0 ** -4, 2.0 ** -5)}}
PERSISTENT_RANKS = (1, 2, 4)
PERSISTENT_LAYERS = (1, 2, 3)


def colchunk_hop_sums(torch, parts, n: int):
    """For the column-chunked ring (``comm/ring.py::chunk_ar_phase``): the
    sum over each output column chunk's hops of |the partial sum after the
    hop|, in f32; chunk c's sum starts at rank c + 1 and travels right.
    ``parts`` (n, B, N): each rank's partial product."""
    chunks = parts.reshape(n, parts.shape[1], n, -1)       # [rank, B, chunk, cn]
    out = []
    for c in range(n):
        acc, tot = chunks[(c + 1) % n, :, c], 0
        for i in range(2, n + 1):
            acc = acc + chunks[(c + i) % n, :, c]
            tot = tot + acc.abs()
        out.append(tot)
    return torch.stack(out, dim=1).reshape(parts.shape[1], -1)


def kernel_act(torch, mesh, b: int, f: int, out_dtype):
    """The SwiGLU activations (n, B, F / n) the last K15 swiglu call on
    ``mesh`` multiplied by down: its act landing buffer, which the call
    leaves as it wrote it."""
    from triton_distributed_tpu_torch.core import symm

    n = mesh.shape["tp"]
    return symm.landing(mesh, "tp", "fused_ar_act", (b * f,), out_dtype).data.reshape(
        n, b, f).float()


def rounding_unit(torch, dtype) -> float:
    return 2.0 ** -8 if dtype == torch.bfloat16 else F32_UNIT


def act_bound(torch, x, gate_up, f: int, out_dtype):
    """The plain version's SwiGLU activations a (n, B, F), its rounded g and
    u, and the stated per-element limit of |K15's act - a|.  Each of g and u
    is a length-K f32 sum (each side within K 2**-24 sum|x w| of the exact
    value, in its own order) rounded once to out_dtype: two values that far
    apart round at most one ulp (2 u |v|, u the unit) further apart.  silu
    is 1.1-Lipschitz, so t = silu(g) u moves at most 1.1 dg (|u| + du) +
    |silu(g)| du, plus 2**-16 of itself for the two sides' f32 evaluations
    of silu and the product; then one rounding of t to out_dtype, which
    may flip."""
    import torch.nn.functional as F

    u = rounding_unit(torch, out_dtype)
    k = x.shape[-1]
    xf, gu = x.float(), gate_up.float()
    sums, moves = [], []
    for w in (gu[..., :f], gu[..., f:]):
        v = torch.matmul(xf, w)
        e = 2 * k * F32_UNIT * torch.matmul(xf.abs(), w.abs())
        sums.append(v.to(out_dtype).float())
        moves.append(e + 2 * u * (v.abs() + e))
    (g, up), (dg, du) = sums, moves
    t = F.silu(g) * up
    dt = 1.1 * dg * (up.abs() + du) + F.silu(g).abs() * du
    dt = dt + 2.0 ** -16 * (t.abs() + dt)
    return t.to(out_dtype).float(), g, up, dt + 2 * u * (t.abs() + dt)


def ring_check(torch, a, wf, out_dtype):
    """(limit, faults) of the column-chunked ring on activations a (n, B, F)
    and weights wf (n, F, N), f32: overlap_limit over the plain version's
    chunk products (each rounded, each hop rounded).  The faults: rank 0's
    partial left out, and chunk 0 taken from chunk 1 (another rank's)."""
    n, f = wf.shape[0], wf.shape[1]
    parts = torch.matmul(a, wf)                                    # (n, B, N)
    values = parts.abs().sum(0) + colchunk_hop_sums(torch, parts, n)
    limit = overlap_limit(torch, torch.matmul(a.abs(), wf.abs()).sum(0), f, values, out_dtype)
    cn = wf.shape[-1] // n

    def faults(got):
        other = got.clone()
        other[:, :cn] = got[:, cn:2 * cn]
        return {"partial_left_out": got.float() - parts[0], "chunk_of_another_rank": other}

    return limit, faults


def own_partials(torch, mesh, m: int, cols: int, out_dtype):
    """The rounded partials (n, M, N) that the last one-shot launch of K15
    (K14's one-shot form included) on ``mesh`` pushed: its product entries,
    which the call leaves as it wrote them."""
    from triton_distributed_tpu_torch.core import symm

    n = mesh.shape["tp"]
    return symm.landing(mesh, "tp", "fused_ar_mm", (1, m * cols), out_dtype).data.reshape(
        n, m, cols)


def slot_sum(torch, parts, out_dtype, twice=None):
    """K11's one-shot fold of the partials (n, M, N): their f32 sum in slot
    order, rounded once to out_dtype.  ``twice``: that slot added a second
    time (a planted fault)."""
    acc = parts[0].float()
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i].float()
        if i == twice:
            acc = acc + parts[i].float()
    return acc.to(out_dtype)


def check_own_reduction(torch, mesh, got, out_dtype, what: str) -> None:
    """The one-shot form's result (each rank's copy, rank-stacked, or the
    (M, N) one) bitwise the slot-order f32 sum of the kernel's own rounded
    partials."""
    m, cols = got.shape[-2:]
    want = slot_sum(torch, own_partials(torch, mesh, m, cols, out_dtype), out_dtype)
    check(got.dtype == out_dtype and torch.equal(got, want.expand_as(got)),
          f"{what}: the one-shot's result is not the slot-order sum of its own partials")


def oneshot_check(torch, a, wf, out_dtype, mesh):
    """(limit, faults) of the one-shot form on activations a (n, M, F) and
    weights wf (n, F, N), f32: overlap_limit over the plain version's
    roundings (each rank's partial product, then the slot-order sum once;
    no hop between).  The faults: rank 0's partial left out, and slot 1
    added twice to the kernel's own partials."""
    f, m, cols = wf.shape[1], a.shape[-2], wf.shape[-1]
    parts = torch.matmul(a, wf)                                    # (n, M, N)
    values = parts.abs().sum(0) + parts.sum(0).abs()
    limit = overlap_limit(torch, torch.matmul(a.abs(), wf.abs()).sum(0), f, values, out_dtype)

    def faults(got):
        own = own_partials(torch, mesh, m, cols, out_dtype)
        return {"partial_left_out": got.float() - parts[0],
                "slot_added_twice": slot_sum(torch, own, out_dtype, twice=1)}

    return limit, faults


def reduction_check(torch, a, wf, out_dtype, mesh, one_shot: bool):
    """(limit, faults) of K15's reduction in its one-shot or ring form."""
    if one_shot:
        return oneshot_check(torch, a, wf, out_dtype, mesh)
    return ring_check(torch, a, wf, out_dtype)


def k15_check(torch, form: str, act, w, out_dtype, gate_up=None, chain_act=None, mesh=None,
              one_shot: bool = True):
    """(limit, chain_limit, judge) of K15 per element of the (B, N) result.
    ``form`` "linear": act (n, B, F) h, w (n, F, N); "swiglu": act the (B,
    K) x, gate_up (n, K, 2F), w the down (n, F, N), ``chain_act`` the
    chain's own activations (the psum path rounds g, u, silu(g) and the
    product in x's dtype).  ``one_shot``: the one-shot form, else the ring.
    The limit against the plain version is the form's (oneshot_check or
    ring_check); the swiglu form adds the stated act limit (act_bound)
    carried through |down| and the reduction's roundings, and, against the
    chain, |the plain act - the chain's| carried the same way: no term
    reads the kernel.  ``judge(got, want)``, called right after a kernel
    call, returns (shares, faults): shares of a limit that must stay within
    1, and each planted fault's share, which must reach FAULT_MARGIN.  The
    one-shot's result must also be bitwise the slot-order sum of its own
    partials (check_own_reduction).  linear: the form's faults against the
    plain version.  swiglu: the kernel's activations (read back,
    ``kernel_act``) against the plain ones within the stated act limit,
    with two planted prologue faults (silu left out; gate and up swapped);
    and the kernel's result against the form's plain walk on the kernel's
    own activations within the form's limit on them, with its faults."""
    from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod
    from triton_distributed_tpu_torch.ops import fused_decode as FD

    n, f = w.shape[0], w.shape[1]
    wf = w.float()
    method = AllReduceMethod.ONE_SHOT if one_shot else AllReduceMethod.TWO_SHOT
    if form != "swiglu":
        limit, faults = reduction_check(torch, act.float(), wf, out_dtype, mesh, one_shot)

        def judge_linear(got, want):
            if one_shot:
                check_own_reduction(torch, mesh, got, out_dtype, "K15 linear")
            return {}, {k: overlap_share(torch, bad, want, limit) for k, bad in faults(got).items()}

        return limit, limit, judge_linear
    a, g, up, da = act_bound(torch, act, gate_up, f, out_dtype)
    red_limit, _ = reduction_check(torch, a, wf, out_dtype, mesh, one_shot)
    carry = 1 + 2 * rounding_unit(torch, out_dtype) * (n + 1)   # the product and n sums
    limit = red_limit + carry * torch.matmul(da, wf.abs()).sum(0)
    chain_limit = limit + carry * torch.matmul((a - chain_act.float()).abs(), wf.abs()).sum(0)

    def judge_swiglu(got, want):
        import torch.nn.functional as F

        if one_shot:
            check_own_reduction(torch, mesh, got, out_dtype, "K15 swiglu")
        ak = kernel_act(torch, mesh, a.shape[1], f, out_dtype)
        walked = FD._walk_ar(False, ak.to(out_dtype), None, w, mesh, "tp", out_dtype, method)
        k_limit, k_faults = reduction_check(torch, ak, wf, out_dtype, mesh, one_shot)
        shares = {"act": overlap_share(torch, ak, a, da),
                  "walk_on_kernel_act": overlap_share(torch, got, walked, k_limit)}
        faults = {"silu_left_out": overlap_share(torch, (g * up).to(out_dtype), a, da),
                  "gate_up_swapped": overlap_share(torch, (F.silu(up) * g).to(out_dtype), a, da)}
        faults.update({k: overlap_share(torch, bad, walked, k_limit)
                       for k, bad in k_faults(got).items()})
        return shares, faults

    return limit, chain_limit, judge_swiglu


def k15_calls(torch, mesh, x, gate_up, down, h, w, out_dtype) -> list:
    """(label, kernel thunk, plain thunk, chain thunk, limit, chain limit,
    judge) of K15's two bodies in each reduction form: the one-shot through
    the public entries (their choice at these sizes, checked), the ring
    forced through the private launcher (``_launch_ar``).  Chains: swiglu,
    the psum path (each rank's gate/up product and SwiGLU, the f32 partials
    of the down product summed); linear, the ar path (each rank's product,
    then K11)."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod
    from triton_distributed_tpu_torch.layers import tp_mlp
    from triton_distributed_tpu_torch.ops import fused_decode as FD
    from triton_distributed_tpu_torch.ops.matmul import batched_product

    one, ring = AllReduceMethod.ONE_SHOT, AllReduceMethod.TWO_SHOT
    nbytes = x.shape[0] * w.shape[-1] * out_dtype.itemsize
    check(FD.ar_method(nbytes, mesh.shape["tp"]) == one,
          f"K15 at B={x.shape[0]} N={w.shape[-1]}: the size rule did not pick the one-shot")

    def chain_act():
        a = tp_mlp.act_combine(tp_mlp.replicated_column_gemm(x, gate_up))
        return a if a.dtype == out_dtype else a.to(out_dtype)

    def psum_chain():
        a = chain_act()
        return batched_product(a, down.to(a.dtype), torch.float32).sum(0).to(out_dtype)

    def ar_chain():
        return comm.all_reduce(batched_product(h, w, out_dtype), mesh)[0]

    return [("fused_mlp_ar/swiglu/one_shot",
             lambda: FD.fused_mlp_ar(x, gate_up, down, mesh, out_dtype=out_dtype),
             lambda: FD.fused_mlp_ar_ref(x, gate_up, down, mesh, out_dtype=out_dtype, method=one),
             psum_chain, *k15_check(torch, "swiglu", x, down, out_dtype, gate_up,
                                    chain_act(), mesh, one_shot=True)),
            ("fused_linear_ar/linear/one_shot",
             lambda: FD.fused_linear_ar(h, w, mesh, out_dtype=out_dtype),
             lambda: FD.fused_linear_ar_ref(h, w, mesh, out_dtype=out_dtype, method=one),
             ar_chain, *k15_check(torch, "linear", h, w, out_dtype, mesh=mesh, one_shot=True)),
            ("fused_mlp_ar/swiglu/ring",
             lambda: FD._launch_ar(True, x, gate_up, down, mesh, "tp", out_dtype, ring),
             lambda: FD.fused_mlp_ar_ref(x, gate_up, down, mesh, out_dtype=out_dtype, method=ring),
             psum_chain, *k15_check(torch, "swiglu", x, down, out_dtype, gate_up,
                                    chain_act(), mesh, one_shot=False)),
            ("fused_linear_ar/linear/ring",
             lambda: FD._launch_ar(False, h, None, w, mesh, "tp", out_dtype, ring),
             lambda: FD.fused_linear_ar_ref(h, w, mesh, out_dtype=out_dtype, method=ring),
             ar_chain, *k15_check(torch, "linear", h, w, out_dtype, mesh=mesh, one_shot=False))]


def judge_k15(torch, label: str, got, want, limit, judge, what: str) -> tuple[dict, dict]:
    """``got`` within ``limit`` of ``want`` and within what ``judge``
    states, each planted fault FAULT_MARGIN limits away.  Returns (shares,
    faults) keyed by label."""
    extra, faults = judge(got, want)
    shares = {label: overlap_share(torch, got, want, limit),
              **{f"{label}/{k}": v for k, v in extra.items()}}
    for key, share in shares.items():
        check(share <= 1.0, f"{what} {key}: the kernel is {share:.3g} of its limit")
    faults = {f"{label}/{k}": v for k, v in faults.items()}
    for key, share in faults.items():
        check(share >= FAULT_MARGIN, f"{what} {key}: the planted fault is only {share:.3g} "
                                     "of its limit away")
    return shares, faults


def check_k15_calls(torch, calls, what: str) -> tuple[dict, dict, dict]:
    """Each call within its limits (judge_k15) and within its limit of its
    chain (whose rounding points are not the kernel's: cuBLAS products),
    every pad at rest after it, each planted fault at least FAULT_MARGIN
    limits away.  Returns the worst shares of the limits against plain and
    chain, and the least share per planted fault."""
    shares, chain_shares, faulty = {}, {}, {}
    for label, kern, plain, chain, limit, chain_limit, judge in calls:
        got = kern()
        want, link = plain(), chain()
        torch.cuda.synchronize()
        check(pads_at_rest(), f"{what} {label}: a signal pad is not at rest after the call")
        s, fl = judge_k15(torch, label, got, want, limit, judge, what)
        shares.update(s)
        faulty.update(fl)
        chain_shares[label] = overlap_share(torch, got, link, chain_limit)
        check(chain_shares[label] <= 1.0, f"{what} {label}: the kernel is "
                                          f"{chain_shares[label]:.3g} of its limit from its chain")
    return shares, chain_shares, faulty


def k15_operands(torch, gen, n, b, k, f, cn, dt):
    """Unit-variance x and h, weights of variance 1 / fan-in (rank-stacked)."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    return (rnd(b, k), rnd(n, k, 2 * f, scale=k ** -0.5), rnd(n, f, n * cn, scale=(n * f) ** -0.5),
            rnd(n, b, f), rnd(n, f, n * cn, scale=(n * f) ** -0.5))


def folded_k4_case(torch, n: int, dtype) -> dict:
    """K4 rank-folded over n ranks against n tp = 1 launches of K4, one per
    rank, on copies of the same folded pools: outputs and pools bitwise."""
    from triton_distributed_tpu_torch.ops import fused_decode as FD

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 71 + n)
    b, k_dim, hk, g, d, ps, mp, pages = 3, 512, 2, 4, 128, 16, 4, 12
    h = hk * g
    x = (torch.randn(b, k_dim, generator=gen, device=dev)).to(dtype)
    wqkv = (torch.randn(n, k_dim, (h + 2 * hk) * d, generator=gen, device=dev)
            * k_dim ** -0.5).to(dtype)
    qn = (torch.randn(d, generator=gen, device=dev) * 0.2 + 1).to(dtype)
    kn = (torch.randn(d, generator=gen, device=dev) * 0.2 + 1).to(dtype)
    pool_k = torch.randn(n * pages, hk, ps, d, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(n * pages, hk, ps, d, generator=gen, device=dev).to(dtype)
    table = torch.cat([torch.randperm(pages, generator=torch.Generator().manual_seed(SEED + r))
                       [:b * mp].reshape(b, mp) + r * pages for r in range(n)]).to(torch.int32).to(dev)
    lens = torch.tensor([[0, ps, mp * ps - 1][i % 3] + r for r in range(n) for i in range(b)],
                        dtype=torch.int32, device=dev).clamp(max=mp * ps - 1)
    kw = dict(rope_theta=1e6, qk_eps=1e-6)
    fk, fv = pool_k.clone(), pool_v.clone()
    out, _, _ = FD.fused_attn_decode(x, wqkv, qn, kn, fk, fv, table, lens, **kw)
    sk, sv = pool_k.clone(), pool_v.clone()
    singles = [FD.fused_attn_decode(x, wqkv[r], qn, kn, sk, sv, table[r * b:(r + 1) * b],
                                    lens[r * b:(r + 1) * b], **kw)[0] for r in range(n)]
    torch.cuda.synchronize()
    same = (torch.equal(out, torch.stack(singles)) and torch.equal(fk, sk)
            and torch.equal(fv, sv))
    check(same, f"K4 folded n={n} {dtype}: differs from {n} tp = 1 launches")
    plain, _, _ = FD.fused_attn_decode_ref(x, wqkv[n - 1], qn, kn, pool_k.clone(), pool_v.clone(),
                                           table[(n - 1) * b:], lens[(n - 1) * b:], **kw)
    err = (out[n - 1].float() - plain.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"K4 folded n={n} {dtype}: {err} from its plain version")
    return {"n": n, "dtype": str(dtype), "bitwise_vs_tp1_launches": True, "max_abs_err": err,
            "tol": tol}


def phase_fused_tp_cases(tt, torch) -> None:
    """K15 at its edges and the rank-folded K4: both bodies in both
    reduction forms (the one-shot and the ring) at n 2, 3, 4; f32, bf16 and
    bf16 -> f32; B 1, 3, 4, 5; K, F / n and N / n off the 64 tile; each call
    within its stated limit of its plain version (the form's schedule walked
    with PyTorch ops) and of its chain, the one-shot's result bitwise the
    slot-order sum of its own partials, each planted fault FAULT_MARGIN
    limits away, every pad at rest; three interleaved repeats bitwise;
    widths off 16-byte rows refused; then K4 rank-folded at n 2 and 4
    against n tp = 1 launches."""
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    for n in OVERLAP_RANKS:
        mesh = make_mesh({"tp": n})
        for dt, odt in OVERLAP_DTYPES:
            for k, f, cn in FUSED_AR_SHAPES:
                worst, worst_chain, least = {}, {}, {}
                for b in FUSED_AR_ROWS:
                    ops = k15_operands(torch, gen, n, b, k, f, cn, dts[dt])
                    calls = k15_calls(torch, mesh, *ops, dts[odt])
                    s, sc, fl = check_k15_calls(torch, calls, f"K15 n={n} {dt}->{odt} B={b} "
                                                              f"K={k} F/n={f} N/n={cn}")
                    for d_, src, op in ((worst, s, max), (worst_chain, sc, max), (least, fl, min)):
                        for key, v in src.items():
                            d_[key] = op(d_.get(key, v), v)
                emit({"phase": "fused_tp_case", "kernel": "K15", "n": n, "dtype": f"{dt}->{odt}",
                      "rows": list(FUSED_AR_ROWS), "k_f_cn": [k, f, cn],
                      "one_shot_reduction_bitwise": True,
                      "worst_share_of_limit": worst, "worst_share_vs_chain": worst_chain,
                      "faulty_share_of_limit": least, "pads_at_rest": True})
    mesh = make_mesh({"tp": 4})
    ops = k15_operands(torch, gen, 4, 5, 264, 40, 24, torch.bfloat16)
    calls = k15_calls(torch, mesh, *ops, torch.bfloat16)
    first = [kern() for _, kern, *_ in calls]
    outs = [[kern() for _, kern, *_ in calls] for _ in range(3)]
    torch.cuda.synchronize()
    for rep in outs:
        for (label, *_), got, ref in zip(calls, rep, first):
            check(torch.equal(got, ref), f"repeat {label}: differs from its first call")
    check(pads_at_rest(), "a signal pad is not at rest after the interleaved repeats")
    emit({"phase": "fused_tp_case", "kernel": "K15", "repeats": 3,
          "interleaved": [c[0] for c in calls], "bitwise": True, "pads_at_rest": True})
    # widths whose rows are not 16-byte vectors are refused on the card
    refused = False
    try:
        tt.fused_linear_ar(ops[3][..., :12], ops[4][:, :12, :4 * 6], mesh)
    except ValueError as e:
        refused = "multiples of 8" in str(e)
    check(refused, "K15 took N / n = 6: rows that are not 16-byte vectors must raise")
    for n in (2, 4):
        for dtype in (torch.float32, torch.bfloat16):
            emit({"phase": "fused_tp_case", "kernel": "K4 rank-folded",
                  **folded_k4_case(torch, n, dtype)})
    emit({"phase": "fused_tp_cases", "seconds": time.perf_counter() - t0})


def fused_tp_main_rows(tt, torch) -> dict:
    """K15's two forms and the rank-folded K4 at Qwen3-8B tp = 4, B = 4,
    bf16 (the shapes of a "fused" step: x (4, 4096), gate_up_r (4096, 6144),
    down_r (3072, 4096); the o-projection h_r (4, 1024), w_r (1024, 4096);
    K4's wqkv_r (4096, 1536) over the folded pages at position 1056), each
    within its limit of its plain version, timed beside its bound (the
    function's bytes over all ranks: every weight and input read once, the
    output written once), its plain version and its chains.  K15's chains:
    the psum path (each rank's product, SwiGLU, the f32 partials summed) and
    the ar path (each rank's product, then K11); K4's: the per-kernel
    attention of the psum step (each rank's qkv product, qk-norm, RoPE, the
    append, K3 over the folded batch)."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.layers import tp_mlp
    from triton_distributed_tpu_torch.models.kv_cache import append_token
    from triton_distributed_tpu_torch.obs import costs
    from triton_distributed_tpu_torch.ops import attention as A
    from triton_distributed_tpu_torch.ops import fused_decode as FD
    from triton_distributed_tpu_torch.ops.matmul import batched_product
    from triton_distributed_tpu_torch.ops.rope import apply_rope, rope_freqs

    n, bf, b = COLL_TP, torch.bfloat16, BATCH
    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    k, f, hid = c.hidden, c.intermediate // n, c.hidden
    mesh = make_mesh({"tp": n})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 101)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    rows = {}
    x, gu, dn = rnd(b, k), rnd(n, k, 2 * f, scale=k ** -0.5), rnd(n, f, hid, scale=(n * f) ** -0.5)
    h, wo = rnd(n, b, c.num_heads * c.head_dim // n), rnd(n, c.num_heads * c.head_dim // n, hid,
                                                           scale=(c.num_heads * c.head_dim) ** -0.5)
    one, ring = AllReduceMethod.ONE_SHOT, AllReduceMethod.TWO_SHOT
    # the o-projection's four weights (33.6 MB) fit in the 50 MB L2: also
    # timed cycling through four copies (134 MB), as a step's layers find them
    wos = [wo] + [wo.clone() for _ in range(3)]
    for name, form, kern, plain, ring_kern, ring_plain, chains, checks, ring_checks, cost, \
            fn_bytes, lib, cold in (
            ("fused_mlp_ar[swiglu]", "swiglu", lambda: FD.fused_mlp_ar(x, gu, dn, mesh),
             lambda: FD.fused_mlp_ar_ref(x, gu, dn, mesh),
             lambda: FD._launch_ar(True, x, gu, dn, mesh, "tp", bf, ring),
             lambda: FD.fused_mlp_ar_ref(x, gu, dn, mesh, method=ring),
             {"psum": lambda: batched_product(tp_mlp.act_combine(torch.matmul(x, gu)), dn,
                                              torch.float32).sum(0).to(bf),
              "ar": lambda: comm.all_reduce(torch.matmul(tp_mlp.act_combine(torch.matmul(x, gu)),
                                                         dn), mesh)[0]},
             k15_check(torch, "swiglu", x, dn, bf, gu,
                       tp_mlp.act_combine(torch.matmul(x, gu)), mesh, one_shot=True),
             k15_check(torch, "swiglu", x, dn, bf, gu,
                       tp_mlp.act_combine(torch.matmul(x, gu)), mesh, one_shot=False),
             costs.fused_mlp_ar(b, k, f, hid, n, bf, one_shot=True),
             nbytes(x, gu, dn) + b * hid * 2, None, None),
            ("fused_linear_ar[o]", "linear", lambda: FD.fused_linear_ar(h, wo, mesh),
             lambda: FD.fused_linear_ar_ref(h, wo, mesh),
             lambda: FD._launch_ar(False, h, None, wo, mesh, "tp", bf, ring),
             lambda: FD.fused_linear_ar_ref(h, wo, mesh, method=ring),
             {"ar": lambda: comm.all_reduce(torch.matmul(h, wo), mesh)[0],
              "psum": lambda: batched_product(h, wo, torch.float32).sum(0).to(bf)},
             k15_check(torch, "linear", h, wo, bf, mesh=mesh, one_shot=True),
             k15_check(torch, "linear", h, wo, bf, mesh=mesh, one_shot=False),
             costs.fused_mlp_ar(b, h.shape[-1], h.shape[-1], hid, n, bf, swiglu=False,
                                one_shot=True),
             nbytes(h, wo) + b * hid * 2,
             (h.permute(1, 0, 2).reshape(b, -1), wo.reshape(-1, hid)),
             (rotating([lambda w=w: FD.fused_linear_ar(h, w, mesh) for w in wos]),
              rotating([lambda w=w: FD._launch_ar(False, h, None, w, mesh, "tp", bf, ring)
                        for w in wos])))):
        check(FD.ar_method(b * hid * 2, n) == one,
              f"{name}: the size rule did not pick the one-shot at decode")
        limit, chain_limit, judge = checks
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        shares, faults = judge_k15(torch, name, got, want, limit, judge, "main row")
        share = shares[name]
        chain_share = {key: overlap_share(torch, got, fn(), chain_limit)
                       for key, fn in chains.items()}
        err = (got.float() - want.float()).abs().max().item()
        r_limit, _, r_judge = ring_checks
        got_r, want_r = ring_kern(), ring_plain()
        torch.cuda.synchronize()
        ring_shares, ring_faults = judge_k15(torch, name + "/ring", got_r, want_r, r_limit, r_judge,
                                             "main row, the ring form")
        del got, want, got_r, want_r
        # the one-shot and the ring in turns: one-shot, ring, ring, one-shot
        t = [perf_func(fn, iters=20)[1] for fn in (kern, ring_kern, ring_kern, kern)]
        ms, ring_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        cold_t = ([perf_func(fn, iters=20)[1] for fn in (cold[0], cold[1], cold[1], cold[0])]
                  if cold else None)
        _, plain_ms = perf_func(plain, iters=3)
        chain_ms = {key: perf_func(fn, iters=20)[1] for key, fn in chains.items()}
        lib_ms = perf_func(lambda w=lib: torch.matmul(*w), iters=20)[1] if lib else None
        bound_ms, bound_by = bound(n * cost.flops, fn_bytes, H100_BF16_FLOPS)
        first = "psum" if form == "swiglu" else "ar"
        rows[name] = dict(
            name=name, route="cuda", source=FUSED_AR_SOURCE,
            replaces="triton_distributed_tpu/ops/fused_decode.py:507", max_abs_err=err,
            reduction="one_shot", worst_share_of_limit=share, worst_share_vs_chains=chain_share,
            shares_of_limits=shares, faulty_share_of_limit=faults, reduction_bitwise=True,
            ms=ms, ms_runs=[t[0], t[3]], ring_ms=ring_ms, ring_ms_runs=[t[1], t[2]],
            ring_shares_of_limits=ring_shares, ring_faulty_share_of_limit=ring_faults,
            **({"ms_rotating_weights": (cold_t[0] + cold_t[3]) / 2,
                "ring_ms_rotating_weights": (cold_t[1] + cold_t[2]) / 2} if cold_t else {}),
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            library="torch.matmul of the whole unsharded product" if lib else None,
            chain_ms=chain_ms[first], chain=f"the {first} path",
            chains_ms=chain_ms, flops=n * cost.flops, function_bytes=fn_bytes,
            shape=f"n={n} B={b} " + (f"K={k} F/n={f} N={hid}" if form == "swiglu"
                                     else f"F/n={h.shape[-1]} N={hid}") + " bf16",
            counter="fused_mlp_ar" if form == "swiglu" else "fused_linear_ar",
            form=(("one_shot", n, b, k, f, hid) if form == "swiglu"
                  else ("one_shot", n, b, h.shape[-1], hid)))
    del x, gu, dn, h, wo, wos
    # K4 rank-folded at the attention shapes of one layer
    hq, hk, d = c.num_heads // n, c.num_kv_heads // n, c.head_dim
    x = rnd(b, k)
    wqkv = rnd(n, k, (hq + 2 * hk) * d, scale=k ** -0.5)
    qn, kn = rnd(d, scale=0.1) + 1, rnd(d, scale=0.1) + 1
    cache = tt.init_paged_cache(1, b, c.num_kv_heads, MAX_LEN, d, bf, page_size=PAGE,
                                device="cuda", tp=n)
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    cache.seq_lens.fill_(DECODE_POS)
    kw = dict(rope_theta=c.rope_theta, qk_eps=c.rms_eps)
    kern = lambda: FD.fused_attn_decode(x, wqkv, qn, kn, cache.k[0], cache.v[0],  # noqa: E731
                                        cache.block_table, cache.seq_lens, **kw)[0]
    plain = lambda: FD._fused_attn_folded_ref(  # noqa: E731
        x, wqkv, qn, kn, cache.k[0], cache.v[0], cache.block_table, cache.seq_lens,
        sm_scale=d ** -0.5, **kw)[0]
    pos = cache.seq_lens.to(torch.float32)[:, None, None]
    cos, sin = rope_freqs(pos, d, theta=c.rope_theta)

    def chain():
        qkv = torch.matmul(x, wqkv)                                   # (n, B, cols)
        q, kk, v = qkv.reshape(n * b, 1, -1).split([hq * d, hk * d, hk * d], dim=-1)
        q = tt.rms_norm(q.reshape(n * b, 1, hq, d).transpose(1, 2), qn, c.rms_eps)
        kk = tt.rms_norm(kk.reshape(n * b, 1, hk, d).transpose(1, 2), kn, c.rms_eps)
        v = v.reshape(n * b, 1, hk, d).transpose(1, 2)
        q = apply_rope(q, cos, sin)[:, :, 0].contiguous()
        kk = apply_rope(kk, cos, sin)[:, :, 0]
        append_token(cache, 0, kk, v[:, :, 0])
        return A.paged_decode_attention(q, cache.k[0], cache.v[0], cache.block_table,
                                        cache.seq_lens + 1)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(err <= BF16_TOL, f"K4 rank-folded main row: {err} from its plain version")
    _, ms = perf_func(kern, iters=20)
    _, plain_ms = perf_func(plain, iters=3)
    _, chain_ms = perf_func(chain, iters=20)
    cost = costs.fused_attn_decode(b, k, hq, hk, DECODE_POS, d, bf)
    bound_ms, bound_by = bound(n * cost.flops, n * cost.bytes_accessed, H100_BF16_FLOPS)
    rows["fused_attn_decode[tp4]"] = dict(
        name="fused_attn_decode[tp4]", route="cuda", source=FUSED_SOURCE,
        replaces="triton_distributed_tpu/ops/fused_decode.py:112", max_abs_err=err, tol=BF16_TOL,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library=None, chain_ms=chain_ms,
        chain="each rank's qkv product, qk-norm, RoPE, the append, K3 over the folded batch",
        flops=n * cost.flops, function_bytes=n * cost.bytes_accessed,
        shape=f"n={n} B={b} K={k} heads {hq}/{hk} a rank, D={d}, position {DECODE_POS} bf16",
        counter="fused_attn_decode", form=(n, b, k, hq, hk, d))
    del cache, x, wqkv
    gc.collect()
    torch.cuda.empty_cache()
    check(pads_at_rest(), "a signal pad is not at rest after K15's and K4's main rows")
    return rows


def phase_fused_tp(tt, torch) -> dict:
    """K15 and the rank-folded K4: edge cases, then the main rows (their
    launches are read from the serve_tp path)."""
    t0 = time.perf_counter()
    phase_fused_tp_cases(tt, torch)
    rows = fused_tp_main_rows(tt, torch)
    for row in rows.values():
        emit({"phase": "kernel_main", **{k: v for k, v in row.items() if k != "form"}})
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "fused_tp", "seconds": time.perf_counter() - t0})
    return rows


def tiny_dense(tt, torch, *, hidden, heads, kv_heads, head_dim, inter, layers, dtype):
    """Qwen3-8B's config at narrow widths and a few layers."""
    return dataclasses.replace(tt.QWEN3_8B, num_layers=layers, hidden=hidden, num_heads=heads,
                               num_kv_heads=kv_heads, head_dim=head_dim, intermediate=inter,
                               vocab=512, max_length=128, dtype=dtype)


def x_share(torch, got, want, tol) -> float:
    """max |got - want| / (tol_rms rms(want row) + tol_rel |want|)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    limit = tol[0] * rms + tol[1] * w.abs()
    return float(((g - w).abs() / limit.clamp_min(1e-30)).max())


def moved_token(torch, after, before, table, lens, ps, n_layers):
    """The pools with every layer's appended token moved one slot on (a
    planted fault): the slot at pos back to its value before the step, the
    token at pos + 1."""
    bad = after.clone()
    pages = table.long().gather(1, (lens.long() // ps)[:, None])[:, 0]
    off = lens.long() % ps
    nxt_pages = table.long().gather(1, ((lens.long() + 1) // ps).clamp(
        max=table.shape[1] - 1)[:, None])[:, 0]
    nxt_off = (lens.long() + 1) % ps
    for l in range(n_layers):
        bad[l, nxt_pages, :, nxt_off] = after[l, pages, :, off]
        bad[l, pages, :, off] = before[l, pages, :, off]
    return bad


def phase_persistent_cases(tt, torch) -> None:
    """K16 at its edges: n 1, 2, 4; 1, 2 and 3 layers; narrow
    widths (hidden 256 with head_dim 64 and 2 query heads a kv head, hidden
    512 with head_dim 128 and 4); f32 and bf16; qk-norm on and off; ragged
    lengths with a position on a page boundary and one in the table's last
    slot; three steps in a row on one cache.  Each step's x_out and pools
    within PERSISTENT_TOL of the plain version (the ring's order) and of the
    tp = n "fused" step (K4 rank-folded, K15, PyTorch norms and adds), every
    pad at rest after it; the planted faults (one rank's o-projection partial
    left out at one layer, every token appended one slot on) at least
    FAULT_MARGIN limits away."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    shapes = ((256, 4, 2, 64, 512), (512, 4, 4, 128, 1024))
    for n in PERSISTENT_RANKS:
        for layers in PERSISTENT_LAYERS:
            hidden, kvh, g, d, inter = shapes[layers % 2]
            for dtype in (torch.float32, torch.bfloat16):
                c = tiny_dense(tt, torch, hidden=hidden, heads=kvh * g, kv_heads=kvh,
                               head_dim=d, inter=inter, layers=layers, dtype=dtype)
                c = dataclasses.replace(c, qk_norm=(layers + n) % 2 == 0)
                emit(persistent_case(tt, torch, c, n, dev))
    emit({"phase": "persistent_cases", "seconds": time.perf_counter() - t0})


def persistent_case(tt, torch, c, n: int, dev) -> dict:
    """One K16 configuration: three steps from one prefilled cache."""
    from triton_distributed_tpu_torch.ops import persistent_decode as PD

    mesh = tt.make_mesh({"tp": n}) if n > 1 else None
    gen = torch.Generator(device=dev).manual_seed(SEED + 91 + n + c.num_layers)
    # weights of variance 1 / fan-in: each sublayer's output is O(1)
    model = tt.Qwen3(c, mesh=mesh, device=None if mesh else dev)
    params = model.init(gen, scale=c.hidden ** -0.5)
    fused = tt.Qwen3(c, mesh=mesh, device=None if mesh else dev, decode_mode="fused")
    b, ps = 3, 16
    cache = tt.init_paged_cache(c.num_layers, b, c.num_kv_heads, c.max_length, c.head_dim,
                                c.dtype, page_size=ps, device=dev, tp=n)
    cache.k.normal_(generator=gen)
    # V of mean one: the attention output, an average of V rows, stays O(1)
    cache.v.normal_(generator=gen).add_(1.0)
    mp = cache.block_table.shape[1]
    base = torch.tensor([ps - 1, 2 * ps - 1, mp * ps - 4], dtype=torch.int32, device=dev)
    cache.seq_lens.copy_(base.repeat(n))
    sp = PD.stack_decode_params(params)
    kw = dict(rope_theta=c.rope_theta, rms_eps=c.rms_eps,
              qk_eps=c.rms_eps if c.qk_norm else None)
    form = PD.served_form(c.dtype, c.head_dim, c.num_heads // c.num_kv_heads, b, c.hidden,
                          c.intermediate // n)
    order = plain_order(form)
    tol = PERSISTENT_TOL[str(c.dtype)[6:]]
    worst = {"x_vs_plain": 0.0, "pool_vs_plain": 0.0, "x_vs_fused": 0.0, "pool_vs_fused": 0.0}
    faults = {}
    for step in range(3):
        x = params.embed[torch.randint(0, c.vocab, (b,), generator=gen, device=dev)]
        before = (cache.k.clone(), cache.v.clone())
        pk, pv = cache.k, cache.v
        got, _, _ = PD.persistent_decode_step(x, sp, pk, pv, cache.block_table, cache.seq_lens,
                                              mesh, **kw)
        torch.cuda.synchronize()
        check(pads_at_rest(), f"K16 n={n} L={c.num_layers}: a signal pad is not at rest")
        rk, rv = before[0].clone(), before[1].clone()
        want, _, _ = PD.reference_decode_step(x, sp, rk, rv, cache.block_table, cache.seq_lens,
                                              mesh, order=order, **kw)
        fk, fv = before[0].clone(), before[1].clone()
        fcache = dataclasses.replace(cache, k=fk, v=fv, seq_lens=cache.seq_lens.clone())
        link = fused_hidden(fused, params, fcache, x)
        shares = {"x_vs_plain": x_share(torch, got, want, tol["x"]),
                  "pool_vs_plain": max(x_share(torch, pk, rk, tol["pool"]),
                                       x_share(torch, pv, rv, tol["pool"])),
                  "x_vs_fused": x_share(torch, got, link, tol["x"]),
                  "pool_vs_fused": max(x_share(torch, pk, fk, tol["pool"]),
                                       x_share(torch, pv, fv, tol["pool"]))}
        for key, v in shares.items():
            worst[key] = max(worst[key], v)
            check(v <= 1.0, f"K16 n={n} L={c.num_layers} {c.dtype} step {step}: {key} at "
                            f"{v:.3g} of its limit")
        if step == 0:
            moved = moved_token(torch, pk, before[0], cache.block_table, cache.seq_lens, ps,
                                c.num_layers)
            faults["token_one_slot_on"] = x_share(torch, moved, rk, tol["pool"])
            if n > 1:
                bad = dropped_partial_step(PD, x, sp, before, cache, mesh, c.num_layers - 1, kw,
                                           order)
                faults["o_partial_left_out"] = x_share(torch, bad, want, tol["x"])
            for key, v in faults.items():
                check(v >= FAULT_MARGIN, f"K16 n={n} L={c.num_layers}: the planted fault {key} "
                                         f"is only {v:.3g} of the limit away")
        cache.seq_lens += 1
    del model, params, sp
    return {"phase": "persistent_case", "form": form, "plain_order": order, "n": n,
            "layers": c.num_layers, "hidden": c.hidden,
            "head_dim": c.head_dim, "group": c.num_heads // c.num_kv_heads,
            "dtype": str(c.dtype), "qk_norm": c.qk_norm, "steps": 3,
            "lens_first": cache.seq_lens[:3].tolist(), "worst_share_of_limit": worst,
            "faulty_share_of_limit": faults, "tol": tol, "pads_at_rest": True}


def plain_order(form: str) -> str:
    """The order of K16's plain version that matches ``form``: the served
    form's one-shot exchange, or the f32 / head dim 64 body's ring."""
    return "oneshot" if form == "stream" else "ring"


def dropped_partial_step(PD, x, sp, pools, cache, mesh, layer: int, kw, order: str = "ring",
                         rank: int = 1, scale: float = 0.0):
    """The plain step with rank ``rank``'s o-projection partial left out of
    layer ``layer``'s sum (a planted fault), or counted ``scale`` times: the
    plain version (in ``order``) run with its K15 linear reference fed that
    rank's input times ``scale`` at that layer."""
    real, calls = PD.fused_linear_ar_ref, [0]

    def faulty(h, w, mesh, axis="tp", **kws):
        if calls[0] == layer:
            h = h.clone()
            h[rank] *= scale
        calls[0] += 1
        return real(h, w, mesh, axis, **kws)

    PD.fused_linear_ar_ref = faulty
    try:
        return PD.reference_decode_step(x, sp, pools[0].clone(), pools[1].clone(),
                                        cache.block_table, cache.seq_lens, mesh, order=order,
                                        **kw)[0]
    finally:
        PD.fused_linear_ar_ref = real


def fused_hidden(model, params, cache, x):
    """The hidden state after every layer of one "fused" step (the chain
    K16 replaces: K4 for every rank, K15's two forms, PyTorch's norms and
    adds), the cache appended in place."""
    from triton_distributed_tpu_torch.layers.norm import rms_norm

    c = model.config
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.ln1, c.rms_eps)
        x = x + model._attn_decode_paged_fused(lp.attn, h, cache, li)
        x = x + model._mlp_decode(lp.mlp, rms_norm(x, lp.ln2, c.rms_eps))
    return x


def phase_sync_check(tt, torch, params) -> None:
    """One MoE layer's decode and prefill forward at the main shapes under
    ``torch.cuda.set_sync_debug_mode("error")``: any read back to the host
    inside the layer (splits, a count, a nonzero) raises."""
    c = tt.QWEN3_30B_A3B
    dev = torch.device("cuda")
    moe = tt.MoEMLP(num_experts=c.num_experts, top_k=c.top_k, swiglu=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    layer = params.layers[0].mlp
    xs = {name: torch.randn((rows, c.hidden), generator=g, device=dev).to(c.dtype)
          for name, rows in (("forward_replicated", BATCH), ("forward_tp", MOE_TOKENS))}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {name: getattr(moe, name)(layer, x) for name, x in xs.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name, y in outs.items():
        check(y.shape == xs[name].shape and bool(torch.isfinite(y).all()),
              f"MoE {name}: bad output {tuple(y.shape)}")
    emit({"phase": "sync_check", "ok": True,
          "calls": {n: list(x.shape) for n, x in xs.items()}})


# the 30B-A3B serve phases (tp = 1 and EP) run 24 of the model's 48 layers,
# every width as published: the depth is cut so that the whole script keeps
# room under its time limit on a slow machine
MOE_SERVE_LAYERS = 24
MOE_SERVE_MODES = (
    ("moe paged", "paged", "psum", None, "paged_decode_attention"),
    ("moe paged+fused", "paged", "fused", None, "fused_attn_decode"),
)
MOE_REQUESTS = 2


def phase_serve_moe(tt, torch) -> tuple[dict, dict, dict]:
    """Qwen3-30B-A3B at full width and MOE_SERVE_LAYERS (24) of its 48 layers
    in two modes (paged K3, paged + fused K4), with the launch counters set
    to 0 before each mode's requests and read after: per prefill K1 and two
    K5 a layer, per decode step the mode's kernel and two K5 a layer,
    nothing else.  Then the sync check
    and a profile of each mode; then, its engines freed, the same draw
    serves the EP model at tp = 4 (phase_serve_ep).  Returns the launches
    summed over the modes and the EP modes, the launches by form (K5's
    (T, K, N), K17's and K18's forms), summed likewise, and the EP kernel
    rows."""
    c = dataclasses.replace(tt.QWEN3_30B_A3B, max_length=MAX_LEN, num_layers=MOE_SERVE_LAYERS)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tt.Qwen3(c, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    models = {mode: tt.Qwen3(c, device=dev, decode_mode=mode)
              for mode in ("psum", "fused", "persistent")}
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", "model": "Qwen3-30B-A3B",
          "init_s": time.perf_counter() - t0,
          "param_bytes": torch.cuda.memory_allocated()})
    phase_sync_check(tt, torch, params)
    engines = {}
    totals = dict.fromkeys(tt.launch_counts(), 0)
    form_totals: dict = {}
    tp, f2 = BATCH * PROMPT * c.top_k, 2 * c.moe_intermediate
    td = BATCH * c.top_k
    want_forms = {   # per request: two prefills and GEN decode steps
        ("grouped_matmul", (tp, c.hidden, f2)): 2 * c.num_layers,
        ("grouped_matmul", (tp, c.moe_intermediate, c.hidden)): 2 * c.num_layers,
        ("grouped_matmul", (td, c.hidden, f2)): GEN * c.num_layers,
        ("grouped_matmul", (td, c.moe_intermediate, c.hidden)): GEN * c.num_layers}
    for label, layout, mode, kv_dtype, kernel in MOE_SERVE_MODES:
        eng = tt.Engine(models[mode], params, batch=BATCH, cache_layout=layout,
                        page_size=PAGE, kv_dtype=kv_dtype)
        tt.reset_launch_counts()
        for req in range(MOE_REQUESTS):
            ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(200 + req))
            before, before_f = tt.launch_counts(), tt.launch_forms()
            tokens, stats = eng.serve(ids, GEN)
            torch.cuda.synchronize()
            after, after_f = tt.launch_counts(), tt.launch_forms()
            delta = {k: after[k] - before[k] for k in after}
            delta_f = {k: n - before_f.get(k, 0) for k, n in after_f.items()}
            want = dict.fromkeys(delta, 0)
            want["flash_attention"] = 2 * c.num_layers
            want[kernel] = GEN * c.num_layers
            want["grouped_matmul"] = 2 * c.num_layers * (2 + GEN)
            emit({"phase": "serve", "layout": label, "request": req, **stats,
                  "launches": delta,
                  "grouped_matmul_by_form": [[list(f), n] for (_, f), n in delta_f.items()]})
            check(delta == want, f"{label} request {req}: launches {delta}, want {want}")
            check(delta_f == want_forms,
                  f"{label} request {req}: K5 launches by form {delta_f}, want {want_forms}")
            check(tuple(tokens.shape) == (BATCH, GEN) and tokens.dtype == torch.int32
                  and int(tokens.min()) >= 0 and int(tokens.max()) < c.vocab,
                  f"{label}: bad tokens {tokens.shape} {tokens.dtype}")
        for k, n in tt.launch_counts().items():
            totals[k] += n
        for k, n in tt.launch_forms().items():
            form_totals[k] = form_totals.get(k, 0) + n
        engines[label] = (eng, ids)
    emit({"phase": "serve_memory", "model": "Qwen3-30B-A3B",
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "device_total": torch.cuda.get_device_properties(0).total_memory})
    for label, (eng, ids) in engines.items():
        phase_profile(eng, ids, torch, label)
    check(sum(form_totals.values()) == totals["grouped_matmul"],
          f"K5 launches by form {form_totals} do not add up to {totals['grouped_matmul']}")
    # the tp = 1 engines' caches go; the draw serves the EP model at tp = 4
    del engines, models, eng
    gc.collect()
    torch.cuda.empty_cache()
    ep_launches, ep_forms_, ep_rows = phase_serve_ep(tt, torch, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in ep_launches.items():
        totals[k] += n
    for key, n in ep_forms_.items():
        form_totals[key] = form_totals.get(key, 0) + n
    return totals, form_totals, ep_rows


def phase_parity_moe(tt, torch) -> None:
    """Qwen3-30B-A3B at full width and 2 layers in f32: card (kernels) vs
    CPU (plain versions) from the same weights.  Prefill logits; then, for
    the paged psum and paged fused modes from one cache state (the CPU's
    prefill, copied to the card), 8 greedy decode steps with the CPU's token
    fed to both sides, every step's logits within PARITY_TOL, the same
    greedy tokens, and the same top-8 experts for every token in every
    layer and step (prefill included): no choice may differ."""
    import triton_distributed_tpu_torch.layers.moe as moe_mod

    c = dataclasses.replace(tt.QWEN3_30B_A3B, num_layers=2, dtype=torch.float32,
                            max_length=256)
    dev = torch.device("cuda")
    b, s, gen = 2, 128, 8
    params = tt.Qwen3(c, device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 11))
    cparams = to_cpu(torch, params)
    ids = torch.randint(0, c.vocab, (b, s), generator=torch.Generator().manual_seed(SEED + 12))
    routes = {"card": [], "cpu": []}
    side = ["card"]
    route = moe_mod.topk_route

    def recording_route(logits, k, **kw):   # the expert ids each side chose
        eid, wts = route(logits, k, **kw)
        routes[side[0]].append(eid)
        return eid, wts

    def differing():
        """Choices (token, layer, step) in which the card's top-8 set differs
        from the CPU's, and both sides' routing calls so far."""
        n = 0
        for a, b_ in zip(routes["card"], routes["cpu"]):
            a_sorted, b_sorted = a.cpu().sort(-1).values, b_.sort(-1).values
            n += sum(len(set(x.tolist()) - set(y.tolist()))
                     for x, y in zip(a_sorted, b_sorted))
        return n, len(routes["card"]), len(routes["cpu"])

    def paged(where):
        return tt.init_paged_cache(c.num_layers, b, c.num_kv_heads, c.max_length,
                                   c.head_dim, c.dtype, page_size=PAGE, device=where)

    def copy(cache, where):
        return dataclasses.replace(cache, **{
            f.name: getattr(cache, f.name).to(where, copy=True)
            for f in dataclasses.fields(cache) if getattr(cache, f.name) is not None})

    moe_mod.topk_route = recording_route
    try:
        gpu, cpu = tt.Qwen3(c, device=dev), tt.Qwen3(c, device="cpu")
        glog, _ = gpu.prefill(params, paged(dev), ids.to(dev))
        side[0] = "cpu"
        clog, ccache = cpu.prefill(cparams, paged("cpu"), ids)
        err = (glog.cpu() - clog).abs()
        ok_logits = bool((err <= PARITY_TOL + PARITY_TOL * clog.abs()).all())
        prefill_diff = differing()
        out = {"phase": "parity", "config": "Qwen3-30B-A3B width, 2 layers, f32",
               "batch": b, "prompt": s, "new_tokens": gen,
               "prefill_logits_max_abs_err": err.max().item(), "tol": PARITY_TOL,
               "logits_ok": ok_logits, "prefill_expert_choices_differing": prefill_diff[0],
               "routing_calls": prefill_diff[1:]}
        emit(out)
        check(ok_logits, f"MoE prefill logits differ card vs CPU by {err.max().item()}")
        check(prefill_diff[0] == 0 and prefill_diff[1] == prefill_diff[2] == c.num_layers,
              f"MoE prefill expert choices differ card vs CPU: {prefill_diff}")
        tok0 = clog[:, -1].argmax(-1).to(torch.int32)
        for label, mode in (("moe paged", "psum"), ("moe paged+fused", "fused")):
            card, host = (tt.Qwen3(c, device=w, decode_mode=mode) for w in (dev, "cpu"))
            hcache = copy(ccache, "cpu")
            gcache = copy(ccache, dev)
            routes["card"].clear()
            routes["cpu"].clear()
            tok, worst, share, same = tok0, 0.0, 0.0, True
            for _ in range(gen):
                side[0] = "card"
                g_ = card.decode(params, gcache, tok.to(dev))[0].cpu()
                side[0] = "cpu"
                c_ = host.decode(cparams, hcache, tok)[0]
                e = (g_ - c_).abs()
                limit = PARITY_TOL + PARITY_TOL * c_.abs()
                worst = max(worst, e.max().item())
                share = max(share, (e / limit).max().item())
                same = same and torch.equal(g_.argmax(-1), c_.argmax(-1))
                tok = c_.argmax(-1).to(torch.int32)
            n_diff, n_card, n_cpu = differing()
            emit({"phase": "parity", "mode": label, "decode_steps": gen,
                  "decode_logits_max_abs_err": worst, "tol": PARITY_TOL,
                  "worst_share_of_tol": share, "tokens_equal": same,
                  "expert_choices_differing": n_diff, "routing_calls": [n_card, n_cpu]})
            check(share <= 1.0, f"{label}: decode logits differ card vs CPU by {worst}")
            check(same, f"{label}: greedy tokens differ between the card and the CPU")
            check(n_diff == 0 and n_card == n_cpu == gen * c.num_layers,
                  f"{label}: {n_diff} expert choices differ card vs CPU")
    finally:
        moe_mod.topk_route = route
    del params, cparams
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# expert parallelism: K17 (the EP all-to-all), K18 (the wire pack), the
# parity-slot AllGather layer (B17, on K9), and Qwen3-30B-A3B under EP at
# tp = 4 on co-located ranks

A2A_SOURCE = "triton_distributed_tpu_torch/csrc/all_to_all.cu"
PACK_SOURCE = "triton_distributed_tpu_torch/csrc/quant_pack.cu"
EP_RANKS = (2, 3, 4, 8)
EP_WIDTHS = (8, 136, 2048)
# packed u8 rows: K18 packs H a multiple of 16 into H + 128 bytes (K17 moves
# rows of a multiple of 16 bytes and refuses others, checked below)
EP_U8_WIDTHS = (16, 144, 2048)
EP_MODES = ("uniform", "one_peer", "silent", "empty_experts", "short")
EP_TP = 4
# The fp8 EP layer on the card against the tp = 1 layer with the codec where
# the wire applies it: the same arithmetic and the same codes (K18 is bitwise
# its plain version), so one bf16 ulp of the result, at most 2^-7 of it.
FP8_LAYER_RTOL = 2.0 ** -7
# The fp8 prefill, card against CPU: a share of the fp8-vs-bf16 wire gap the
# same run measures on the CPU (f32 sums that differ in the last bits flip a
# code at an e4m3 boundary; the bf16 wire's logits must fail the limit).
FP8_GAP_SHARE = 0.25
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores, H100 SXM


def ep_splits(torch, gen, n: int, t: int, e: int, mode: str):
    """(n, E) int32 rows per expert of each rank's T rows, on the card:
    uniform; every row to rank n - 1's first expert; rank 1 sending
    nothing; half the experts empty; totals short of T."""
    out = torch.zeros((n, e), dtype=torch.int32)
    for r in range(n):
        tot = t if mode != "short" else int(torch.randint(0, t + 1, (1,), generator=gen))
        if mode == "one_peer":
            ids = torch.full((tot,), e - e // n)
        elif mode == "silent" and r == 1:
            ids = torch.zeros((0,), dtype=torch.long)
        elif mode == "empty_experts":
            ids = torch.randint(0, e // 2, (tot,), generator=gen) * 2
        else:
            ids = torch.randint(0, e, (tot,), generator=gen)
        out[r] = torch.bincount(ids, minlength=e)
    return out.cuda()


def plant_landing(torch) -> int:
    """Fill every EP landing buffer with NaN (u8: 0xFF, an e4m3 NaN and a
    NaN scale): what a zone tail or a stale row holds must not reach a
    result.  Returns the buffers planted."""
    from triton_distributed_tpu_torch.core import symm

    planted = 0
    for key, buf in symm._landing.items():
        if key[3] in ("ep_dispatch", "ep_combine"):
            buf.fill_(255 if buf.dtype == torch.uint8 else float("nan"))
            planted += 1
    return planted


def a2a_case(torch, mesh, x, spl, config=None) -> None:
    """K17's dispatch and combine of ``x`` against the plain versions, the
    landing buffers planted with NaN first: every valid zone row and
    recv_splits bitwise, combine's real rows bitwise and equal to ``x``'s
    (the round trip), every pad at rest after each call."""
    from triton_distributed_tpu_torch import comm

    n, t = x.shape[0], x.shape[1]
    want, want_rs = comm.ep_dispatch_ref(x, spl, mesh, "tp", config=config)
    # both landing buffers exist, then every byte of them is NaN
    comm.ep_combine(comm.ep_dispatch(x, spl, mesh, "tp", config=config)[0], spl, mesh, "tp",
                    token_dim=t, config=config)
    plant_landing(torch)
    recv, rs = comm.ep_dispatch(x, spl, mesh, "tp", config=config)
    torch.cuda.synchronize()
    check(pads_at_rest(), "a signal pad is not at rest after a dispatch")
    check(torch.equal(rs, want_rs) and recv.shape == want.shape, "recv_splits differ")
    sent = spl.reshape(n, n, -1).sum(-1).cpu()   # [source, destination]
    for r in range(n):
        for p in range(n):
            cnt = int(sent[p, r])
            check(torch.equal(recv[r, p, :cnt], want[r, p, :cnt]),
                  f"dispatch: rank {r}'s zone from {p} differs from the plain version")
    back = comm.ep_combine(want, spl, mesh, "tp", token_dim=t, config=config)
    torch.cuda.synchronize()
    check(pads_at_rest(), "a signal pad is not at rest after a combine")
    back_ref = comm.ep_combine_ref(want, spl, mesh, "tp", token_dim=t, config=config)
    for r, tot in enumerate(spl.sum(1).tolist()):
        check(torch.equal(back[r, :tot], back_ref[r, :tot]) and torch.equal(back[r, :tot],
                                                                             x[r, :tot]),
              f"combine: rank {r}'s rows differ from the plain version or the input")


def a2a_system_scope(torch, gen, cgen) -> None:
    """K17 in its system-scope form (kept for the multi-card host: the entry
    barrier, system-scope flags) at n = 4 on 8192 bf16 rows of 4096 bytes a
    rank, uniform over 128 experts (the EP prefill's width and rows):
    dispatch and combine bitwise the plain versions on the valid rows, like
    the device-scope form, every pad at rest after each; both forms of the
    dispatch timed in turns (a kernel_main line; no path runs the
    system-scope form, so it is not in the kernels line)."""
    from triton_distributed_tpu_torch.comm import all_to_all as A
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    n, t, h = EP_TP, MOE_TOKENS // EP_TP * 8, 2048
    mesh = make_mesh({"tp": n})
    spl = ep_splits(torch, gen, n, t, 128, "uniform")
    x = torch.randn((n, t, h), generator=cgen, device="cuda").to(torch.bfloat16)
    cfg = A.AllToAllConfig()
    want, want_rs = A._dispatch(x, spl, mesh, "tp", cfg, plain=True)
    sent = spl.reshape(n, n, -1).sum(-1).cpu()
    forms = {scope: (lambda system=(scope == "system"): A._dispatch(
        x, spl, mesh, "tp", cfg, system_scope=system)[0]) for scope in ("device", "system")}
    for scope, fn in forms.items():
        recv = fn()
        torch.cuda.synchronize()
        check(pads_at_rest(), f"K17 dispatch, {scope} scope: a signal pad is not at rest")
        check(all(torch.equal(recv[r, p, :int(sent[p, r])], want[r, p, :int(sent[p, r])])
                  for r in range(n) for p in range(n)),
              f"K17 dispatch, {scope} scope: a zone differs from the plain version")
        back = A._combine(want, spl, mesh, "tp", t, cfg, system_scope=scope == "system")
        torch.cuda.synchronize()
        check(pads_at_rest(), f"K17 combine, {scope} scope: a signal pad is not at rest")
        check(torch.equal(back, x), f"K17 combine, {scope} scope: the round trip differs")
    ms = interleaved_ms(torch, forms)
    emit({"phase": "kernel_main", "name": f"all_to_all[dispatch bf16 {t}x{2 * h}B, system scope]",
          "ms": ms["system"], "device_scope_ms": ms["device"], "bitwise": True,
          "pads_at_rest": True, "timed": "in turns, median of 5 rounds of 10 calls"})
    del x, want, want_rs


def pack_edge_rows(torch, gen, rows: int, h: int, dtype):
    """Randn rows with, where there are enough rows, an all-zero row, an
    all-negative row, a denormal-range row and a row with one element at
    1e4."""
    x = torch.randn((rows, h), generator=gen, device="cuda")
    if rows >= 4:
        x[0] = 0.0
        x[1] = -x[1].abs()
        x[2] *= 1e-40
        x[3, h // 2] = 1e4
    return x.to(dtype)


def phase_ep_cases(tt, torch) -> None:
    """K17 at n 2, 3, 4, 8 for f32 and bf16 rows of widths 8, 136 and 2048
    and packed u8 rows of H 16, 144 and 2048 (+ 128 bytes; a row of 136
    bytes is refused), 37 or 200 rows a rank, the split modes in turn, and
    the farthest-first emission order at n 4 and 8; K18 bitwise against its
    plain version on the card at the edge rows (fp8 and int8, f32 and bf16,
    1-1000 rows, H 16-4096); the AllGather layer's parity slots."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.lang import quant as Q

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 51)
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    i = 0
    for n in EP_RANKS:
        mesh = make_mesh({"tp": n})
        for kind in ("f32", "bf16", "u8"):
            for w in (EP_U8_WIDTHS if kind == "u8" else EP_WIDTHS):
                t, mode = (37, 200)[i % 2], EP_MODES[i % len(EP_MODES)]
                i += 1
                spl = ep_splits(torch, gen, n, t, 2 * n, mode)
                if kind == "u8":
                    x = torch.randint(0, 256, (n, t, w + Q.SIDECAR), generator=cgen,
                                      device="cuda", dtype=torch.uint8)
                else:
                    x = torch.randn((n, t, w), generator=cgen, device="cuda").to(
                        torch.float32 if kind == "f32" else torch.bfloat16)
                a2a_case(torch, mesh, x, spl)
                emit({"phase": "ep_case", "kernel": "all_to_all", "n": n, "rows": kind,
                      "row_bytes": x.shape[-1] * x.element_size(), "rows_a_rank": t,
                      "splits": mode, "bitwise": True, "nan_planted": True,
                      "pads_at_rest": True})
        if n >= 4:
            order = tuple(sorted(range(n), key=lambda p: -min(p, n - p)))
            spl = ep_splits(torch, gen, n, 200, 2 * n, "uniform")
            x = torch.randn((n, 200, 136), generator=cgen, device="cuda").to(torch.bfloat16)
            a2a_case(torch, mesh, x, spl, comm.AllToAllConfig(schedule=order))
            emit({"phase": "ep_case", "kernel": "all_to_all", "n": n, "schedule": list(order),
                  "bitwise": True})
        # one row a rank; one row to each peer: most lanes credit a share of
        # zero rows
        for t, per_peer in ((1, False), (n, True)):
            spl = (torch.tensor([1, 0] * n, dtype=torch.int32).repeat(n, 1).cuda() if per_peer
                   else ep_splits(torch, gen, n, t, 2 * n, "uniform"))
            for kind, x in (("bf16", torch.randn((n, t, 2048), generator=cgen, device="cuda")
                             .to(torch.bfloat16)),
                            ("u8", torch.randint(0, 256, (n, t, 2048 + Q.SIDECAR), generator=cgen,
                                                 device="cuda", dtype=torch.uint8))):
                a2a_case(torch, mesh, x, spl)
                emit({"phase": "ep_case", "kernel": "all_to_all", "n": n, "rows": kind,
                      "rows_a_rank": t, "splits": "one row to each peer" if per_peer else
                      "uniform", "bitwise": True, "pads_at_rest": True})
    mesh = make_mesh({"tp": 2})
    try:
        comm.ep_dispatch(torch.zeros((2, 4, 136), dtype=torch.uint8, device="cuda"),
                         torch.full((2, 2), 2, dtype=torch.int32, device="cuda"), mesh, "tp")
        refused = False
    except ValueError:
        refused = True
    check(refused, "K17 took rows of 136 bytes (not a multiple of 16)")
    emit({"phase": "ep_case", "kernel": "all_to_all", "row_bytes": 136, "refused": True})
    a2a_system_scope(torch, gen, cgen)
    for dt in (torch.float32, torch.bfloat16):
        for rows in (1, 37, 1000):
            for h in (16, 2048, 4096):
                x = pack_edge_rows(torch, cgen, rows, h, dt)
                for wire in ("fp8", "int8"):
                    got, want = Q.pack_rows(x, wire), Q.pack_rows_ref(x, wire)
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"K18 {wire} {dt} {rows}x{h}: {int((got != want).sum())} bytes differ "
                          "from the plain version")
                    dec = Q.unpack_rows(got, h, wire, torch.float32)
                    xf = x.float()
                    lim = Q.abs_error_bound(xf.abs().amax(-1, keepdim=True), wire) \
                        + 2.0 ** -23 * xf.abs()
                    check(bool(((dec - xf).abs() <= lim).all()),
                          f"K18 {wire} {dt} {rows}x{h}: decoded rows leave the codec's envelope")
        emit({"phase": "ep_case", "kernel": "quant_pack", "dtype": str(dt),
              "rows": [1, 37, 1000], "h": [16, 2048, 4096], "wires": ["fp8", "int8"],
              "edge_rows": True, "bitwise": True})
    allgather_layer_case(tt, torch)
    emit({"phase": "ep_cases", "seconds": time.perf_counter() - t0})


def allgather_layer_case(tt, torch) -> None:
    """The parity-slot AllGather layer at n = 4: calls alternate the two
    workspaces, call k's result is intact after call k + 1, every result
    equals the plain AllGather, and device memory stays flat from the
    second call on."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh({"tp": EP_TP})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    layer = tt.AllGatherLayer(mesh, 64, (4096,), dtype=torch.bfloat16, axis="tp")
    ws = layer.workspaces
    xs = [torch.randn((EP_TP, 64, 4096), generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(4)]
    out0 = layer(xs[0])
    keep0 = out0.clone()
    out1 = layer(xs[1])
    check(out0 is ws[0] and out1 is ws[1], "the layer's calls do not alternate its slots")
    check(torch.equal(out0, keep0), "call k's result changed during call k + 1")
    keep1 = out1.clone()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    out2 = layer(xs[2])
    check(out2 is ws[0] and torch.equal(out1, keep1), "call k + 1's result changed in k + 2")
    layer(xs[3])
    torch.cuda.synchronize()
    flat = torch.cuda.memory_allocated() == mem
    for x, out in ((xs[2], ws[0]), (xs[3], ws[1])):
        check(torch.equal(out, comm.all_gather_ref(x, mesh, "tp", layer.method)),
              "the layer's gather differs from the plain AllGather")
    check(flat, "the AllGather layer allocated in its steady state")
    check(pads_at_rest(), "a signal pad is not at rest after the AllGather layer")
    emit({"phase": "ep_case", "kernel": "allgather_layer", "method": layer.method.value,
          "slots_alternate": True, "previous_intact": True, "memory_flat": flat,
          "bitwise": True})
    # timed at K9's main row (Qwen3-8B's width under tp = 4, 1024 rows a rank),
    # beside K9's bound, its plain version and one PyTorch call; off the path
    from triton_distributed_tpu_torch.core.utils import perf_func

    big = tt.AllGatherLayer(mesh, BATCH * PROMPT // EP_TP, (COLL_WIDTH,),
                            dtype=torch.bfloat16, axis="tp")
    x = torch.randn((EP_TP, BATCH * PROMPT // EP_TP, COLL_WIDTH), generator=gen,
                    device="cuda").to(torch.bfloat16)
    tt.reset_launch_counts()
    got = big(x)
    launches = tt.launch_counts()["all_gather"]
    check(torch.equal(got, comm.all_gather_ref(x, mesh, "tp", big.method)),
          "the AllGather layer differs from the plain AllGather at K9's main row")
    _, ms = perf_func(lambda: big(x), iters=20)
    _, plain_ms = perf_func(lambda: comm.all_gather_ref(x, mesh, "tp", big.method), iters=3)
    _, lib_ms = perf_func(lambda: x.reshape(1, -1, COLL_WIDTH).expand(EP_TP, -1, -1)
                          .contiguous(), iters=20)
    fn_bytes = nbytes(x) + EP_TP * nbytes(x)
    emit({"phase": "kernel_main", "name": f"allgather_layer[{big.method.value} "
          f"{x.shape[1]}x{COLL_WIDTH}]", "route": "cuda", "source": COLL_SOURCE,
          "replaces": "triton_distributed_tpu/layers/allgather_layer.py:50", "max_abs_err": 0.0,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": fn_bytes / H100_BYTES_PER_S * 1e3,
          "bound_by": "bytes", "library_ms": lib_ms, "library": "expand(...).contiguous()",
          "launches_a_call": launches, "off_the_main_path": True})


def ep_a2a_index(torch, sent, z: int, t: int, combine: bool):
    """The flat source row of every zone row (n, n, Z) of one exchange, from
    the host's (source, destination) counts: the gather that builds the same
    layout (rows past a count read row 0)."""
    n = sent.shape[0]
    idx = torch.zeros((n, n, z), dtype=torch.long)
    for r in range(n):
        for p in range(n):
            if combine:   # back zone p of rank r: rank p's zone r rows
                cnt = int(sent[r, p])
                idx[r, p, :cnt] = (p * n + r) * z + torch.arange(cnt)
            else:          # zone p of rank r: rank p's rows to r
                cnt, first = int(sent[p, r]), int(sent[p, :r].sum())
                idx[r, p, :cnt] = p * t + first + torch.arange(cnt)
    return idx.reshape(-1).cuda()


def ep_main_rows(tt, torch, layer) -> dict:
    """K17 and K18 at Qwen3-30B-A3B's EP prefill (B = 4 x 1024 tokens, top-8:
    8192 rows a rank, four ranks), splits from a real routing of unit
    activations through ``layer``'s router: K17 dispatch and combine on
    bf16 and on packed u8 rows, K18 on the 32768 rows it packs on each hop.
    Each bitwise against its plain version (valid rows),
    timed with CUDA events beside its bound (the real rows read once and
    written once), the plain version and, for K17, one ``index_select``
    gather building the same zones; the path counted once.  Then the layer:
    forward_ep with every landing buffer planted with NaN equals the clean
    call, on both wires; the bf16 wire is held to the tp = 1 layer, the fp8
    wire to the tp = 1 layer with the codec where the wire applies it
    (``fp8_layer_ref``) within FP8_LAYER_RTOL, a limit that the bf16 wire's
    output must miss by FAULT_MARGIN."""
    from triton_distributed_tpu_torch.comm import all_to_all as A
    from triton_distributed_tpu_torch.core import symm
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.lang import quant as Q
    from triton_distributed_tpu_torch.lang.primitives import Team
    from triton_distributed_tpu_torch.obs import costs

    c = tt.QWEN3_30B_A3B
    n, h = EP_TP, c.hidden
    mesh = make_mesh({"tp": n})
    team = Team.of(mesh, "tp")
    moe = tt.MoEMLP(num_experts=c.num_experts, top_k=c.top_k, swiglu=True, mesh=mesh,
                    axis="tp")
    p = moe.shard_params_ep(layer.router, layer.w_up, layer.w_dn)
    g = torch.Generator(device="cuda").manual_seed(SEED + 54)
    x = torch.randn((n, MOE_TOKENS // n, h), generator=g, device="cuda").to(c.dtype)
    x_sorted, splits, _, _ = moe._route_and_sort_ranks(x, p.router)
    t = x_sorted.shape[1]
    cfg = A.AllToAllConfig()
    chunk, z = A.zone_geometry(t, cfg)
    meta = A._meta(splits, team, mesh)
    sent = splits.reshape(n, n, -1).sum(-1).cpu()
    real = int(sent.sum())
    zone_offs = (torch.arange(n, dtype=torch.int32, device="cuda") * z).expand(n, n).contiguous()
    packed = Q.pack_rows(x_sorted, "fp8")
    zones = {}
    for wire, xs in (("bf16", x_sorted), ("u8", packed)):
        zones[wire] = A.ep_dispatch_ref(xs, splits, mesh, "tp")[0]   # zero tails
    # (name, kernel, plain, same(got, want), library (label, thunk) or None,
    #  bound (flops, bytes, rate), form)
    specs = []
    for wire, xs in (("bf16", x_sorted), ("u8", packed)):
        rb = xs.shape[-1] * xs.element_size()
        recv = symm.landing(mesh, "tp", "ep_dispatch", (n, z, xs.shape[-1]), xs.dtype).data
        back = symm.landing(mesh, "tp", "ep_combine", (n, z, xs.shape[-1]), xs.dtype).data
        ys = zones[wire]
        d_idx, c_idx = (ep_a2a_index(torch, sent, z, t, comb) for comb in (False, True))
        cost = costs.all_to_all(real, rb)

        def push(role, src, dst, send, offs, exp, plain):
            A._push(role, src.reshape(n, -1, src.shape[-1]), dst.reshape(n, n, z, -1), send,
                    offs, exp, team, mesh, chunk, z, cfg, plain, -1)
            return dst

        def valid(got, want, sent_to=sent):
            return all(torch.equal(got[r, q, :int(sent_to[q, r])], want[r, q, :int(sent_to[q, r])])
                       for r in range(n) for q in range(n))

        specs.append((
            f"all_to_all[dispatch {wire} {t}x{rb}B]",
            lambda xs=xs, recv=recv: push("dispatch", xs, recv, meta.send, meta.offs,
                                          meta.expected, False),
            lambda xs=xs, recv=recv: push("dispatch", xs, torch.zeros_like(recv), meta.send,
                                          meta.offs, meta.expected, True),
            valid, ("index_select", lambda xs=xs, i=d_idx: xs.reshape(-1, xs.shape[-1])
                    .index_select(0, i)),
            (0, cost.bytes_accessed, H100_BF16_FLOPS), ("dispatch", n, t, rb)))
        specs.append((
            f"all_to_all[combine {wire} {n * z}x{rb}B]",
            lambda ys=ys, back=back: push("combine", ys, back, meta.expected, zone_offs,
                                          meta.send, False),
            lambda ys=ys, back=back: push("combine", ys, torch.zeros_like(back),
                                          meta.expected, zone_offs, meta.send, True),
            lambda got, want: valid(got, want, sent.T),
            ("index_select", lambda ys=ys, i=c_idx: ys.reshape(-1, ys.shape[-1])
             .index_select(0, i)),
            (0, cost.bytes_accessed, H100_BF16_FLOPS), ("combine", n, n * z, rb)))
    # the layer packs the dispatch's rows and the experts' rows, n T of each
    cost = costs.quant_pack(n * t, h, x_sorted.dtype)
    specs.append((
        f"quant_pack[fp8 {n * t}x{h}]", lambda: Q.pack_rows(x_sorted, "fp8"),
        lambda: Q.pack_rows_ref(x_sorted, "fp8"), torch.equal, None,
        (cost.flops, cost.bytes_accessed, H100_F32_FLOPS), ("fp8", n * t, h)))
    # the path: every row once, through the kernels, counted
    torch.cuda.synchronize()
    tt.reset_launch_counts()
    outs = {s[0]: s[1]().clone() for s in specs}
    torch.cuda.synchronize()
    launches, forms = tt.launch_counts(), tt.launch_forms()
    check(pads_at_rest(), "a signal pad is not at rest after the EP path")
    emit({"phase": "ep_path", "launches": {k: v for k, v in launches.items() if v},
          "by_form": [[name, list(f), v] for (name, f), v in forms.items()]})
    rows = {}
    for name, kern, plain, same, lib, (flops, nb, rate), form in specs:
        want = plain()
        check(same(outs.pop(name), want), f"{name}: the kernel differs from its plain version")
        del want
        _, ms = perf_func(kern, iters=20)
        _, plain_ms = perf_func(plain, iters=2)
        lib_ms = perf_func(lib[1], iters=20)[1] if lib else None
        b_ms, b_by = bound(flops, nb, rate)
        k17 = name.startswith("all_to_all")
        rows[name] = dict(
            name=name, route="cuda", source=A2A_SOURCE if k17 else PACK_SOURCE,
            replaces=("triton_distributed_tpu/comm/all_to_all.py:69" if k17
                      else "triton_distributed_tpu/lang/quant.py:145"),
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library=(f"{lib[0]} gather of the zones" if lib else None),
            chain=None if k17 else "the plain chain (no one PyTorch call packs the message)",
            real_rows=real if k17 else form[1], counter="all_to_all" if k17 else "quant_pack",
            form=form)
        emit({"phase": "kernel_main", **{k: v for k, v in rows[name].items() if k != "form"}})
        gc.collect()
    # the layer: NaN in every landing buffer changes nothing; the bf16 wire
    # against tp = 1, the fp8 wire against tp = 1 with the codec
    one = tt.MoEMLP(num_experts=c.num_experts, top_k=c.top_k, swiglu=True)
    refs = {False: one.forward_tp(layer, x.reshape(-1, h)).reshape(x.shape),
            True: fp8_layer_ref(tt, torch, one, layer, x)}
    limits = {False: BF16_TOL + K5_RTOL * refs[False].float().abs(),
              True: F32_UNIT + FP8_LAYER_RTOL * refs[True].float().abs()}
    clean = {}
    for fp8 in (False, True):
        m = dataclasses.replace(moe, fp8_wire=fp8)
        clean[fp8] = m.forward_ep(p, x)
        planted = plant_landing(torch)
        again = m.forward_ep(p, x)
        torch.cuda.synchronize()
        err = (clean[fp8].float() - refs[fp8].float()).abs()
        share = (err / limits[fp8]).max().item()
        emit({"phase": "ep_layer", "fp8_wire": fp8, "nan_planted_buffers": planted,
              "unchanged_by_nan": bool(torch.equal(clean[fp8], again)),
              "finite": bool(torch.isfinite(clean[fp8]).all()),
              "reference": "tp = 1 layer" + (" with the fp8 codec" if fp8 else ""),
              "max_abs_err_vs_ref": err.max().item(), "share_of_tol_vs_ref": share})
        check(torch.equal(clean[fp8], again), f"fp8_wire={fp8}: NaN in the landing buffers "
                                              "changed the layer's output")
        check(bool(torch.isfinite(clean[fp8]).all()), f"fp8_wire={fp8}: the layer's output is "
                                                      "not finite")
        check(share <= 1.0, f"fp8_wire={fp8}: the EP layer differs from its tp = 1 reference "
                            f"by {err.max()}")
    # the control: the bf16 wire (the codec skipped) misses the fp8 limit
    control = ((clean[False].float() - refs[True].float()).abs() / limits[True]).max().item()
    emit({"phase": "ep_layer", "control": "bf16 wire against the fp8 reference",
          "share_of_fp8_tol": control, "required": FAULT_MARGIN})
    check(control >= FAULT_MARGIN, f"the bf16 wire's output is {control} fp8 limits from the "
                                   "fp8 reference: the limit cannot see the codec")
    del x_sorted, packed, zones, outs, recv, back, refs, limits, clean
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def fp8_layer_ref(tt, torch, one, layer, x):
    """The tp = 1 MoE layer ``one`` with the fp8 wire's codec where the EP
    layer applies it: every routed row packed and unpacked before the
    up-projection, every expert row after the down-projection (the plain
    pack).  ``x`` (n, m, K) -> the same."""
    from triton_distributed_tpu_torch.lang import quant as Q
    from triton_distributed_tpu_torch.ops import moe_utils as mu

    def codec(v):
        return Q.unpack_rows(Q.pack_rows_ref(v, "fp8"), v.shape[-1], "fp8", v.dtype)

    xf = x.reshape(-1, x.shape[-1])
    eid, wts = mu.topk_route(torch.matmul(xf, layer.router), one.top_k,
                             renormalize=one.renormalize)
    xr, eflat, wflat = mu.flatten_topk(xf, eid, wts)
    xs, splits, unsort = mu.sort_by_expert(xr, eflat, one.num_experts)
    hh = one._combine(tt.grouped_matmul(codec(xs), layer.w_up, splits))
    y = codec(tt.grouped_matmul(hh, layer.w_dn, splits).to(x.dtype))
    return mu.unsort_combine(y, unsort, wflat, one.top_k).to(x.dtype).reshape(x.shape)


EP_SERVE_MODES = (   # (label, decode mode, fp8 wire, the decode step's attention kernel)
    ("ep4 paged psum", "psum", False, "paged_decode_attention"),
    ("ep4 paged fused", "fused", False, "fused_attn_decode"),
    ("ep4 paged fused fp8", "fused", True, "fused_attn_decode"),
)
EP_REQUESTS = 2


def ep_step_launches(c, mode: str, fp8: bool) -> tuple[dict, dict]:
    """The launches of one prefill and one decode step of Qwen3-MoE at tp = 4
    under EP: per layer a prefill runs one flash attention for every rank,
    the qkv AG-GEMM, the o GEMM-RS, two K17 (dispatch, combine), two K5 and,
    with the fp8 wire, two K18; a step runs the mode's attention ("fused":
    K4 and the o-projection's K15) and two K5."""
    layers = c.num_layers
    prefill = {"flash_attention": layers, "ag_gemm": layers, "gemm_rs": layers,
               "all_to_all": 2 * layers, "grouped_matmul": 2 * layers}
    if fp8:
        prefill["quant_pack"] = 2 * layers
    step = {"grouped_matmul": 2 * layers}
    if mode == "fused":
        step.update({"fused_attn_decode": layers, "fused_linear_ar": layers})
    else:
        step["paged_decode_attention"] = layers
    return prefill, step


def ep_forms(c, fp8: bool) -> tuple[dict, dict]:
    """K5's, K17's and K18's launches of one prefill and one step by form."""
    from triton_distributed_tpu_torch.comm.all_to_all import AllToAllConfig, zone_geometry

    n, layers, h = EP_TP, c.num_layers, c.hidden
    t = BATCH * PROMPT // n * c.top_k
    z = zone_geometry(t, AllToAllConfig())[1]
    f2 = 2 * c.moe_intermediate
    rb = h + 128 if fp8 else 2 * h
    prefill = {("grouped_matmul", (n * t, h, f2)): layers,
               ("grouped_matmul", (n * t, c.moe_intermediate, h)): layers,
               ("all_to_all", ("dispatch", n, t, rb)): layers,
               ("all_to_all", ("combine", n, n * z, rb)): layers}
    if fp8:   # the dispatch's rows and the experts' rows
        prefill[("quant_pack", ("fp8", n * t, h))] = 2 * layers
    step = {("grouped_matmul", (BATCH * c.top_k, h, f2)): layers,
            ("grouped_matmul", (BATCH * c.top_k, c.moe_intermediate, h)): layers}
    return prefill, step


def phase_sync_check_ep(tt, torch, model, params, mesh) -> None:
    """An EP prefill and an EP decode step (paged, tp = 4) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in them may read
    back to the host."""
    c = model.config
    ids = torch.randint(0, c.vocab, (BATCH, 64), device=mesh.device,
                        generator=torch.Generator(device=mesh.device).manual_seed(SEED + 8))
    tok = torch.zeros((BATCH,), dtype=torch.int32, device=mesh.device)
    eng = tt.Engine(model, params, batch=BATCH, cache_layout="paged", page_size=PAGE)
    eng.prefill(ids)
    eng.decode_step(tok)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.prefill(params, eng.cache, ids)
        step, _ = model.decode(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for what, lg in (("prefill", logits[:, -1]), ("step", step)):
        check(tuple(lg.shape) == (BATCH, c.vocab) and bool(torch.isfinite(lg).all()),
              f"EP {what}: bad logits")
    emit({"phase": "sync_check", "tp": EP_TP, "moe_strategy": "ep",
          "moe_fp8_wire": c.moe_fp8_wire, "decode_mode": model.decode_mode,
          "checked": ["prefill", "decode_step"], "ok": True})
    del eng


def phase_serve_ep(tt, torch, params1) -> tuple[dict, dict, dict]:
    """Qwen3-30B-A3B at tp = 4 under expert parallelism on four ranks
    co-located on the card, full width at MOE_SERVE_LAYERS, its weights the tp = 1
    draw of ``params1`` (the experts' tensors shared, the attention sharded):
    first the EP main rows (K17, K18) on layer 0's experts, then per mode
    (paged psum, paged fused, paged fused with the fp8 wire) the launches of
    one prefill and one step, exact and by form, and EP_REQUESTS requests
    with the counters set to 0 just before and read just after; the sync
    check of a prefill and a step in each wire; a profile per mode; peak
    device memory.  Returns the launches, the launches by form and the
    kernel rows."""
    t0 = time.perf_counter()
    rows = ep_main_rows(tt, torch, params1.layers[0].mlp)
    c = dataclasses.replace(tt.QWEN3_30B_A3B, max_length=MAX_LEN, num_layers=MOE_SERVE_LAYERS,
                            moe_strategy="ep")
    mesh = tt.make_mesh({"tp": EP_TP})
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    models = {(mode, fp8): tt.Qwen3(dataclasses.replace(c, moe_fp8_wire=fp8), mesh=mesh,
                                    decode_mode=mode)
              for _, mode, fp8, _ in EP_SERVE_MODES}
    params = models[("psum", False)].shard_params(params1)
    torch.cuda.synchronize()
    emit({"phase": "serve_ep_setup", "tp": EP_TP, "init_s": time.perf_counter() - t0,
          "added_param_bytes": torch.cuda.memory_allocated() - before,
          "experts_shared": params.layers[0].mlp.w_up is params1.layers[0].mlp.w_up})
    check(params.layers[0].mlp.w_up is params1.layers[0].mlp.w_up,
          "the EP experts are not the tp = 1 draw's tensors")
    for key in (("psum", False), ("fused", True)):
        phase_sync_check_ep(tt, torch, models[key], params, mesh)
    totals = dict.fromkeys(tt.launch_counts(), 0)
    forms: dict = {}
    engines = {}
    for label, mode, fp8, _ in EP_SERVE_MODES:
        model = models[(mode, fp8)]
        eng = tt.Engine(model, params, batch=BATCH, cache_layout="paged", page_size=PAGE)
        want_prefill, want_step = ep_step_launches(c, mode, fp8)
        form_prefill, form_step = ep_forms(c, fp8)
        ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=mesh.device,
                            generator=torch.Generator(device=mesh.device).manual_seed(300))
        tt.reset_launch_counts()
        tok = eng.prefill(ids).argmax(-1).to(torch.int32)
        one_prefill = {k: v for k, v in tt.launch_counts().items() if v}
        prefill_forms = {k: v for k, v in tt.launch_forms().items()
                         if k[0] in ("grouped_matmul", "all_to_all", "quant_pack")}
        tt.reset_launch_counts()
        eng.decode_step(tok)
        one_step = {k: v for k, v in tt.launch_counts().items() if v}
        step_forms = {k: v for k, v in tt.launch_forms().items()
                      if k[0] in ("grouped_matmul", "all_to_all", "quant_pack")}
        emit({"phase": "serve_ep_launches", "layout": label, "per_prefill": one_prefill,
              "per_decode_step": one_step,
              "prefill_by_form": [[k, list(f), v] for (k, f), v in prefill_forms.items()],
              "step_by_form": [[k, list(f), v] for (k, f), v in step_forms.items()]})
        check(one_prefill == want_prefill and one_step == want_step,
              f"{label}: launches a prefill {one_prefill} (want {want_prefill}), a step "
              f"{one_step} (want {want_step})")
        check(prefill_forms == form_prefill and step_forms == form_step,
              f"{label}: launches by form {prefill_forms} / {step_forms}, want "
              f"{form_prefill} / {form_step}")
        tt.reset_launch_counts()
        for req in range(EP_REQUESTS):
            ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=mesh.device,
                                generator=torch.Generator(device=mesh.device).manual_seed(
                                    400 + req))
            before = tt.launch_counts()
            tokens, stats = eng.serve(ids, GEN)
            torch.cuda.synchronize()
            after = tt.launch_counts()
            delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            want = {k: 2 * v for k, v in want_prefill.items()}
            for k, v in want_step.items():
                want[k] = want.get(k, 0) + GEN * v
            emit({"phase": "serve_ep", "layout": label, "request": req, **stats,
                  "launches": delta})
            check(delta == want, f"{label} request {req}: launches {delta}, want {want}")
            check(tuple(tokens.shape) == (BATCH, GEN) and int(tokens.min()) >= 0
                  and int(tokens.max()) < c.vocab, f"{label}: bad tokens")
        check(pads_at_rest(), f"{label}: a signal pad is not at rest after the requests")
        for k, v in tt.launch_counts().items():
            totals[k] += v
        for key, v in tt.launch_forms().items():
            forms[key] = forms.get(key, 0) + v
        engines[label] = (eng, ids)
    for i, (label, (eng, ids)) in enumerate(engines.items()):
        # the prefill differs between the wires: profiled in the first and the last
        phase_profile(eng, ids, torch, label, prefill=i != 1)
    emit({"phase": "serve_memory", "model": "Qwen3-30B-A3B tp = 4 EP",
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "device_total": torch.cuda.get_device_properties(0).total_memory})
    del engines, models, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_ep_done", "seconds": time.perf_counter() - t0})
    return totals, forms, rows


def phase_parity_ep(tt, torch) -> None:
    """Qwen3-30B-A3B at full width and 2 layers in f32, batch 2, prompt 128:
    the port under EP at tp = 4 on the card (K17, K5, ...) against EP at
    tp = 4 on the CPU (plain versions) and tp = 1 on the card, from one
    draw.  Prefill logits, then 8 decode steps in paged psum and paged fused
    from the CPU's cache state, the CPU's greedy token fed to every side:
    logits within PARITY_TOL, greedy tokens equal, and every token's top-8
    experts equal in every layer and step.  The fp8 wire's prefill, card
    against CPU: logits within PARITY_TOL + FP8_GAP_SHARE of the CPU's
    fp8-vs-bf16 wire gap (a code at an e4m3 rounding boundary may flip on
    f32 sums that differ in the last bits), a limit the card's bf16-wire
    logits must miss; greedy tokens and the first layer's experts equal."""
    import triton_distributed_tpu_torch.layers.moe as moe_mod

    t0 = time.perf_counter()
    c1 = dataclasses.replace(tt.QWEN3_30B_A3B, num_layers=2, dtype=torch.float32,
                             max_length=256)
    c = dataclasses.replace(c1, moe_strategy="ep")
    dev = torch.device("cuda")
    b, s, gen = 2, 128, 8
    mesh, cmesh = tt.make_mesh({"tp": EP_TP}), tt.make_mesh({"tp": EP_TP}, device="cpu")
    card1 = tt.Qwen3(c1, device=dev)
    params1 = card1.init(torch.Generator(device=dev).manual_seed(SEED + 13))
    card4, cpu4 = tt.Qwen3(c, mesh=mesh), tt.Qwen3(c, mesh=cmesh)
    params4 = card4.shard_params(params1)
    cparams4 = cpu4.shard_params(to_cpu(torch, params1))
    ids = torch.randint(0, c.vocab, (b, s), generator=torch.Generator().manual_seed(SEED + 14))
    routes: dict[str, list] = {}
    side = ["cpu ep4"]
    route = moe_mod.topk_route

    def recording_route(logits, k, **kw):   # every token's expert ids, by side
        eid, wts = route(logits, k, **kw)
        routes.setdefault(side[0], []).append(eid.reshape(-1, k).cpu().sort(-1).values)
        return eid, wts

    def paged(where, tp):
        return tt.init_paged_cache(c.num_layers, b, c.num_kv_heads, c.max_length, c.head_dim,
                                   c.dtype, page_size=PAGE, device=where, tp=tp)

    def compare(logs: dict, what: str, limit=None) -> dict:
        ref = logs["cpu ep4"]
        if limit is None:
            limit = PARITY_TOL + PARITY_TOL * ref.abs()
        errs = {}
        for name, lg in logs.items():
            if name == "cpu ep4":
                continue
            err = (lg - ref).abs()
            errs[name] = err.max().item()
            check(bool((err <= limit).all()), f"{what}: {name} differs from cpu ep4 by "
                                              f"{errs[name]}")
            check(torch.equal(lg.argmax(-1), ref.argmax(-1)),
                  f"{what}: {name}'s greedy tokens differ from cpu ep4's")
        return errs

    def experts_equal(what: str) -> int:
        ref = routes.pop("cpu ep4")
        for name, got in routes.items():
            check(len(got) == len(ref) and all(torch.equal(a, r) for a, r in zip(got, ref)),
                  f"{what}: {name}'s top-8 experts differ from cpu ep4's")
        routes.clear()
        return len(ref)

    sides = {"cpu ep4": (cpu4, cparams4, 4, "cpu"), "card ep4": (card4, params4, 4, dev),
             "card tp1": (card1, params1, 1, dev)}
    moe_mod.topk_route = recording_route
    try:
        start, logs = {}, {}
        for name, (model, params, tp, where) in sides.items():
            side[0] = name
            lg, start[name] = model.prefill(params, paged(where, tp), ids.to(where))
            logs[name] = lg[:, -1].cpu()
        errs = compare(logs, "EP prefill")
        calls = experts_equal("EP prefill")
        emit({"phase": "parity_ep", "what": "prefill", "max_abs_err_vs_cpu_ep4": errs,
              "tol": PARITY_TOL, "routing_calls": calls, "experts_equal": True})
        for mode in ("psum", "fused"):
            models = {name: tt.Qwen3(m.config, decode_mode=mode, **(
                {"mesh": m.mesh} if m.tp > 1 else {"device": m.device}))
                for name, (m, *_) in sides.items()}
            caches = {name: clone_cache(torch, start[name]) for name in sides}
            tok = logs["cpu ep4"].argmax(-1).to(torch.int32)
            worst: dict = {}
            for step in range(gen):
                step_logs = {}
                for name, (_, params, _, where) in sides.items():
                    side[0] = name
                    lg, caches[name] = models[name].decode(params, caches[name], tok.to(where))
                    step_logs[name] = lg.cpu()
                for name, e in compare(step_logs, f"EP {mode} step {step}").items():
                    worst[name] = max(worst.get(name, 0.0), e)
                tok = step_logs["cpu ep4"].argmax(-1).to(torch.int32)
            calls = experts_equal(f"EP {mode} decode")
            emit({"phase": "parity_ep", "mode": mode, "decode_steps": gen,
                  "max_abs_err_vs_cpu_ep4": worst, "tol": PARITY_TOL, "tokens_equal": True,
                  "routing_calls": calls, "experts_equal": True})
        # the fp8 wire, card against CPU (and how far it sits from the bf16 wire)
        c8 = dataclasses.replace(c, moe_fp8_wire=True)
        logs8 = {}
        for name, model in (("cpu ep4", tt.Qwen3(c8, mesh=cmesh)),
                            ("card ep4", tt.Qwen3(c8, mesh=mesh))):
            params, where = sides[name][1], sides[name][3]
            side[0] = name
            lg, _ = model.prefill(params, paged(where, 4), ids.to(where))
            logs8[name] = lg[:, -1].cpu()
        # The pack is bitwise on equal rows (ep_cases, ep_layer), but the two
        # sides' f32 sums differ in the last bits before each pack, and a
        # value at an e4m3 rounding boundary takes the neighbouring code: the
        # logits are held to a share of the whole codec's effect (the fp8
        # wire against the bf16 wire, on the CPU), which the bf16 wire's
        # logits on the card must miss; the tokens and the first layer's
        # experts (routed before any hop) exactly, the later layers'
        # differing choices counted.
        ref8 = logs8["cpu ep4"]
        gap = (ref8 - logs["cpu ep4"]).abs().max().item()
        limit8 = PARITY_TOL + FP8_GAP_SHARE * gap
        errs = compare(logs8, "EP fp8 prefill", limit8)
        control = (logs["card ep4"] - ref8).abs().max().item()
        check(control > limit8, f"EP fp8 prefill: the bf16 wire's logits are within the fp8 "
                                f"limit {limit8} ({control}): it cannot see the codec")
        first = {name: got[0] for name, got in routes.items()}
        check(torch.equal(first["card ep4"], first["cpu ep4"]),
              "EP fp8 prefill: the first layer's top-8 experts differ card vs CPU")
        later = sum(int((a != r).any(-1).sum()) for a, r in zip(routes["card ep4"][1:],
                                                                routes["cpu ep4"][1:]))
        routes.clear()
        emit({"phase": "parity_ep", "what": "prefill, fp8 wire", "max_abs_err_vs_cpu_ep4": errs,
              "tol": PARITY_TOL, "fp8_gap_share": FP8_GAP_SHARE, "limit": limit8,
              "tokens_equal": True, "first_layer_experts_equal": True,
              "later_tokens_with_other_experts": later, "fp8_vs_bf16_wire_max_abs": gap,
              "control_bf16_wire_card_vs_fp8_cpu": control})
    finally:
        moe_mod.topk_route = route
    emit({"phase": "parity_ep_done", "config": "Qwen3-30B-A3B width, 2 layers, f32, tp = 4 EP",
          "batch": b, "prompt": s, "seconds": time.perf_counter() - t0})
    del sides, params4, params1, cparams4, card4, card1, cpu4
    gc.collect()
    torch.cuda.empty_cache()


KERNEL_CLASSES = (("attention", ("flash_fwd", "decode_cluster", "decode_split",
                                 "decode_combine", "fused_attn_decode")),
                  ("grouped_gemm", ("grouped_gemm",)),   # K5, before "gemm"
                  ("overlap_gemm", ("ag_gemm_kernel", "gemm_rs_kernel")),   # K12-K14
                  ("fused_ar", ("fused_ar_kernel",)),                       # K15
                  ("persistent", ("persistent_decode_kernel",
                                  "stream_decode_kernel")),                 # K16
                  ("collective", ("all_gather_kernel", "reduce_scatter_kernel",
                                  "all_reduce_kernel", "a2a_push_kernel")),  # K9-K11, K17
                  ("quant_pack", ("quant_pack_kernel",)),                   # K18
                  ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")))


def phase_profile(eng, ids, torch, layout: str, prefill: bool = True) -> None:
    """Where a prefill (unless ``prefill`` is False) and a decode step spend
    their time: host wall time (no profiler), device kernel time by class
    from a torch.profiler trace, and the device's idle share (1 - kernel
    time / wall time)."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    steps = 8
    tok = eng.prefill(ids).argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if prefill:
        eng.prefill(ids)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        tok = eng.decode_step(tok).argmax(-1).to(torch.int32)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    walls = {"prefill": (t1 - t0) * 1e3, "decode_step": (t3 - t1) * 1e3 / steps}
    enqueue_ms = (t2 - t1) * 1e3 / steps
    for what, n, thunk in (
            ("prefill", 1, lambda: eng.prefill(ids)),
            ("decode_step", steps,
             lambda: [eng.decode_step(tok) for _ in range(steps)]))[0 if prefill else 1:]:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            thunk()
            torch.cuda.synchronize()
        ks = kernels(prof)
        by_name: dict[str, float] = {}
        for e in ks:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        classes = dict.fromkeys([c for c, _ in KERNEL_CLASSES] + ["other"], 0.0)
        for name, ms in by_name.items():
            cls = next((c for c, keys in KERNEL_CLASSES
                        if any(k in name for k in keys)), "other")
            classes[cls] += ms
        device_ms = sum(classes.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        # the decode kernels' launches by name: bf16 at D = 128 is K2/K3's
        # clustered form alone, no combine pass beside it
        decode_launches: dict[str, float] = {}
        for e in ks:
            for key in ("decode_cluster", "decode_split", "decode_combine"):
                if key in e.name:
                    decode_launches[key] = decode_launches.get(key, 0) + 1 / n
        emit({"phase": "profile", "layout": layout, "what": what,
              "wall_ms": walls[what], "device_kernel_ms": device_ms,
              "idle_share": 1.0 - device_ms / walls[what],
              "host_enqueue_ms": enqueue_ms if what == "decode_step" else None,
              "kernel_launches": len(ks) / n,
              "device_ms_by_class": classes,
              "decode_kernel_launches": decode_launches,
              "top_kernels_ms": [[name[:60], ms] for name, ms in top]})
        check(what != "decode_step" or "decode_combine" not in decode_launches,
              f"{layout}: a decode step ran the combine pass: {decode_launches}")


# (label, cache layout, decode mode, kv dtype, the decode step's kernel)
SERVE_MODES = (
    ("contiguous", "contiguous", "psum", None, "decode_attention"),
    ("paged", "paged", "psum", None, "paged_decode_attention"),
    ("paged+fused", "paged", "fused", None, "fused_attn_decode"),
    ("paged+int8", "paged", "psum", "int8", "paged_decode_attention_int8"),
    ("paged+int8+fused", "paged", "fused", "int8", "fused_attn_decode_int8"),
    ("paged+persistent", "paged", "persistent", None, "persistent_decode"),
)
REQUESTS = 2
LAUNCHES_PER_STEP = {"persistent_decode": 1}


def phase_serve(tt, torch) -> tuple[dict, dict, dict]:
    """Qwen3-8B, full width and depth, in each serving mode: the main path,
    with the launch counters set to 0 just before each mode's requests and
    read just after; then a profile of one prefill and a few decode steps
    in each mode, and K16's main row at tp = 1.  Returns the launches summed
    over the modes, the launches by form, and the row."""
    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = tt.Qwen3(c, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    models = {mode: tt.Qwen3(c, device=dev, decode_mode=mode)
              for mode in ("psum", "fused", "persistent")}
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", "init_s": time.perf_counter() - t0,
          "param_bytes": torch.cuda.memory_allocated()})
    engines, forms = {}, {}
    totals = dict.fromkeys(tt.launch_counts(), 0)
    for label, layout, mode, kv_dtype, kernel in SERVE_MODES:
        eng = tt.Engine(models[mode], params, batch=BATCH, cache_layout=layout,
                        page_size=PAGE, kv_dtype=kv_dtype)
        if mode == "persistent":
            sync_check_step(torch, eng, f"tp = 1 {label}")
        tt.reset_launch_counts()
        for req in range(REQUESTS):
            ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(100 + req))
            before = tt.launch_counts()
            tokens, stats = eng.serve(ids, GEN)
            torch.cuda.synchronize()
            after = tt.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            # serve = a warm-up prefill and decode step, then the timed prefill
            # and GEN - 1 decode steps
            want = dict.fromkeys(delta, 0)
            want["flash_attention"] = 2 * c.num_layers
            want[kernel] = GEN * LAUNCHES_PER_STEP.get(kernel, c.num_layers)
            emit({"phase": "serve", "layout": label, "request": req, **stats,
                  "launches": delta})
            check(delta == want, f"{label} request {req}: launches {delta}, want {want}")
            check(tuple(tokens.shape) == (BATCH, GEN) and tokens.dtype == torch.int32
                  and int(tokens.min()) >= 0 and int(tokens.max()) < c.vocab,
                  f"{label}: bad tokens {tokens.shape} {tokens.dtype}")
        for k, n in tt.launch_counts().items():
            totals[k] += n
        for key, n in tt.launch_forms().items():
            forms[key] = forms.get(key, 0) + n
        engines[label] = (eng, ids)
    for label, (eng, ids) in engines.items():
        phase_profile(eng, ids, torch, label)
    row = persistent_main_row(tt, torch, engines["paged+persistent"][0],
                              engines["paged+fused"][0], None)
    emit({"phase": "kernel_main", **{k: v for k, v in row.items() if k != "form"}})
    del engines, models, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return totals, forms, {row["name"]: row}


# Qwen3-8B at tp = 4 on co-located ranks: (label, cache layout, decode mode)
TP_SERVE_MODES = (
    ("tp4 contiguous psum", "contiguous", "psum"),
    ("tp4 paged psum", "paged", "psum"),
    ("tp4 paged ar", "paged", "ar"),
    ("tp4 paged gemm_ar", "paged", "gemm_ar"),
    ("tp4 paged fused", "paged", "fused"),
    ("tp4 paged persistent", "paged", "persistent"),
)
TP_REQUESTS = 2


def tp_step_launches(c, layout: str, mode: str) -> tuple[dict, dict]:
    """The kernel launches of one prefill and of one decode step at tp = 4:
    per layer one flash attention, two AG-GEMMs (qkv, gate_up) and two
    GEMM-RSs (o, down) a prefill; one decode attention a step, and two
    reductions on K11 ("ar") or K14 ("gemm_ar"; B = 4 divides by 4); "fused":
    one K4 for every rank and one K15 of each form a layer; "persistent": one
    K16 a step."""
    layers = c.num_layers
    prefill = {"flash_attention": layers, "ag_gemm": 2 * layers, "gemm_rs": 2 * layers}
    if mode == "persistent":
        return prefill, {"persistent_decode": 1}
    if mode == "fused":
        return prefill, {"fused_attn_decode": layers, "fused_mlp_ar": layers,
                         "fused_linear_ar": layers}
    step = {("paged_decode_attention" if layout == "paged" else "decode_attention"): layers}
    if mode == "ar":
        step["all_reduce"] = 2 * layers
    elif mode == "gemm_ar":
        step["gemm_ar"] = 2 * layers
    return prefill, step


def sync_check_step(torch, eng, what: str) -> None:
    """One decode step of ``eng`` (prefilled, then one step to warm it)
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing in it may read
    back to the host."""
    dev = eng.device
    ids = torch.randint(0, eng.params.embed.shape[0], (eng.batch, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 7))
    tok = torch.zeros((eng.batch,), dtype=torch.int32, device=dev)
    eng.prefill(ids)
    eng.decode_step(tok)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = eng.decode_step(tok)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(tuple(logits.shape) == (eng.batch, eng.params.embed.shape[0])
          and bool(torch.isfinite(logits).all()), f"{what} step: bad logits")
    emit({"phase": "sync_check", "what": what, "ok": True})


def phase_sync_check_tp(tt, torch, models, params, mesh) -> None:
    """The tp = 4 decode step under ``torch.cuda.set_sync_debug_mode("error")``
    in each mode: nothing in it may read back to the host."""
    ids = torch.randint(0, params.embed.shape[0], (BATCH, 64), device=mesh.device,
                        generator=torch.Generator(device=mesh.device).manual_seed(SEED + 7))
    tok = torch.zeros((BATCH,), dtype=torch.int32, device=mesh.device)
    for mode, model in models.items():
        eng = tt.Engine(model, params, batch=BATCH, cache_layout="paged", page_size=PAGE)
        eng.prefill(ids)
        eng.decode_step(tok)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = eng.decode_step(tok)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(tuple(logits.shape) == (BATCH, params.embed.shape[0])
              and bool(torch.isfinite(logits).all()), f"tp = 4 {mode} step: bad logits")
        del eng
    emit({"phase": "sync_check", "tp": 4, "decode_modes": list(models), "ok": True})


def phase_serve_tp(tt, torch) -> tuple[dict, dict]:
    """Qwen3-8B at tp = 4 on four ranks co-located on the card, full width and
    depth, random weights from seed 0 (the tp = 1 draw, sharded): per mode
    the launches of one prefill and one decode step, then TP_REQUESTS
    requests with the launch counters set to 0 just before and read just
    after (K12 +72 and K13 +72 a prefill, K14 +72 a gemm_ar step); the tp = 4
    sync check; a decode step's profile per mode and one prefill's; peak
    device memory.  Returns the launches and the launches by form."""
    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    t0 = time.perf_counter()
    mesh = tt.make_mesh({"tp": COLL_TP})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tt.Qwen3(c, mesh=mesh).init(torch.Generator(device=mesh.device).manual_seed(SEED))
    models = {mode: tt.Qwen3(c, mesh=mesh, decode_mode=mode)
              for mode in ("psum", "ar", "gemm_ar", "fused", "persistent")}
    torch.cuda.synchronize()
    emit({"phase": "serve_tp_setup", "tp": COLL_TP, "init_s": time.perf_counter() - t0,
          "param_bytes": torch.cuda.memory_allocated()})
    phase_sync_check_tp(tt, torch, models, params, mesh)
    totals = dict.fromkeys(tt.launch_counts(), 0)
    forms: dict = {}
    engines = {}
    for label, layout, mode in TP_SERVE_MODES:
        eng = tt.Engine(models[mode], params, batch=BATCH, cache_layout=layout, page_size=PAGE)
        want_prefill, want_step = tp_step_launches(c, layout, mode)
        ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=mesh.device,
                            generator=torch.Generator(device=mesh.device).manual_seed(200))
        tt.reset_launch_counts()
        tok = eng.prefill(ids).argmax(-1).to(torch.int32)
        one_prefill = {k: v for k, v in tt.launch_counts().items() if v}
        tt.reset_launch_counts()
        eng.decode_step(tok)
        one_step = {k: v for k, v in tt.launch_counts().items() if v}
        emit({"phase": "serve_tp_launches", "layout": label, "per_prefill": one_prefill,
              "per_decode_step": one_step})
        check(one_prefill == want_prefill and one_step == want_step,
              f"{label}: launches a prefill {one_prefill} (want {want_prefill}), a step "
              f"{one_step} (want {want_step})")
        tt.reset_launch_counts()
        for req in range(TP_REQUESTS):
            ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=mesh.device,
                                generator=torch.Generator(device=mesh.device).manual_seed(100 + req))
            before = tt.launch_counts()
            tokens, stats = eng.serve(ids, GEN)
            torch.cuda.synchronize()
            after = tt.launch_counts()
            delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            # serve = a warm-up prefill and decode step, then the timed prefill
            # and GEN - 1 decode steps
            want = {k: 2 * v for k, v in want_prefill.items()}
            for k, v in want_step.items():
                want[k] = want.get(k, 0) + GEN * v
            emit({"phase": "serve_tp", "layout": label, "request": req, **stats,
                  "launches": delta})
            check(delta == want, f"{label} request {req}: launches {delta}, want {want}")
            check(tuple(tokens.shape) == (BATCH, GEN) and int(tokens.min()) >= 0
                  and int(tokens.max()) < c.vocab, f"{label}: bad tokens")
        for k, n in tt.launch_counts().items():
            totals[k] += n
        for key, n in tt.launch_forms().items():
            forms[key] = forms.get(key, 0) + n
        engines[label] = (eng, ids)
    for i, (label, (eng, ids)) in enumerate(engines.items()):
        # the prefill is the same in every decode mode: profiled once
        phase_profile(eng, ids, torch, label, prefill=i == 0)
    emit({"phase": "serve_memory", "model": "Qwen3-8B tp = 4",
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "device_total": torch.cuda.get_device_properties(0).total_memory})
    row = persistent_main_row(tt, torch, engines["tp4 paged persistent"][0],
                              engines["tp4 paged fused"][0], mesh)
    emit({"phase": "kernel_main", **{k: v for k, v in row.items() if k != "form"}})
    del engines, models, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_tp_done", "seconds": time.perf_counter() - t0})
    return totals, forms, {row["name"]: row}


# K16's limits at the main row (36 layers, bf16): the bf16 roundings that
# flip grow from layer to layer in this random-weight model, so
# PERSISTENT_TOL is not a limit there.  On an H100, (2**-3, 2**-4) put K16's
# x_out at 1.63 and its pools at 1.69 of it (while the two-layer f32 step
# stayed within 2.1e-5 of the CPU): these are 2x that.  Each run prints two
# sound yardsticks against the same plain version, the "fused" chain and
# the plain version in JAX's order of adds, and the planted faults: every
# token one slot on, and one rank's o-projection partial left out at layer
# 0, 1, L / 2 and L - 1.  The first two must land FAULT_MARGIN limits away.
# The later partials are readings, not checks: the sound versions' drift
# from the plain x_out grows with depth, while one rank's partial at a late
# layer moves x_out by about one bf16 ulp of x, so no limit on x_out tells
# the two apart (PERF.md gives the readings).
PERSISTENT_MAIN_TOL = {"x": (2.0 ** -2, 2.0 ** -3), "pool": (2.0 ** -2, 2.0 ** -3)}
# K16's limits on one full-width layer (Qwen3-8B's last, fed the plain
# hidden state entering it): 3/8 of PERSISTENT_TOL's bf16 limits.  On an
# H100 both forms' x_out came within 0.13-0.16 of PERSISTENT_TOL and their
# pools within 0.013, while rank 1's o partial left out moved x_out 0.86-0.88
# of it: this limit lies between the two (0.35-0.42 and 2.3-2.35 of it).  One
# rank's partial at a late layer is a few bf16 ulps of the residual stream,
# so no limit on x_out puts it FAULT_MARGIN limits away; the presence of
# each rank's partial is checked on its own (PERSISTENT_PRESENCE_TOL).
PERSISTENT_ONE_LAYER_TOL = {k: (0.375 * a, 0.375 * r)
                            for k, (a, r) in PERSISTENT_TOL["bfloat16"].items()}
# The presence of rank r's o-projection partial in a one-layer x_out: with
# g_r = want - (the plain step without that partial), <got - want, g_r> /
# <g_r, g_r> is 0 when the partial is counted once, -1 when it is left out
# and about 1 when it is counted twice.  Rounding that flips does not line up
# with g_r, so a sound kernel's reading is a small fraction of this limit.
PERSISTENT_PRESENCE_TOL = 2.0 ** -5


def device_kernel_ms(torch, thunk, steps: int) -> float:
    """The device kernel time of one call of ``thunk``, in ms: the sum of
    the kernels' times in a torch.profiler trace of ``steps`` calls (after
    one untraced call), over ``steps``."""
    from torch.profiler import ProfilerActivity, profile

    thunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            thunk()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps


def persistent_main_row(tt, torch, eng, fused_eng, mesh) -> dict:
    """One 36-layer K16 step of Qwen3-8B at tp = 4 (``mesh``) or 1 (None),
    on the served engine's weights and cache (B = 4), in its served form,
    within PERSISTENT_MAIN_TOL of its plain version in that form's order
    (one-shot, on the card), timed beside its bound (every weight of the
    step, the K/V prefix of every rank and x read once, x and the appended
    slots written), its plain version, its chain (the device kernel time of
    one "fused" step: K4, K15 and the norms and adds, from a trace); the
    barriers a step counted from the form's schedule
    (``ops/persistent_decode.py::step_stages``); and the one-layer check at
    full width on both forms (:func:`persistent_one_layer`)."""
    import types

    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.obs import costs
    from triton_distributed_tpu_torch.ops import persistent_decode as PD

    c, params, cache = eng.model.config, eng.params, eng.cache
    n, b, L = 1 if mesh is None else mesh.shape["tp"], eng.batch, c.num_layers
    form = PD.served_form(c.dtype, c.head_dim, c.num_heads // c.num_kv_heads, b, c.hidden,
                          c.intermediate // n)
    order = plain_order(form)
    sp = eng.stacked()
    tok = torch.randint(0, c.vocab, (b,), device=eng.device,
                        generator=torch.Generator(device=eng.device).manual_seed(SEED + 111))
    x = params.embed[tok]
    kw = dict(rope_theta=c.rope_theta, rms_eps=c.rms_eps, qk_eps=c.rms_eps if c.qk_norm else None)
    before = (cache.k.clone(), cache.v.clone())
    rk, rv = before[0].clone(), before[1].clone()
    fcache = dataclasses.replace(cache, k=before[0].clone(), v=before[1].clone(),
                                 seq_lens=cache.seq_lens.clone())
    got, _, _ = PD.persistent_decode_step(x, sp, cache.k, cache.v, cache.block_table,
                                          cache.seq_lens, mesh, **kw)
    want, _, _ = PD.reference_decode_step(x, sp, rk, rv, cache.block_table, cache.seq_lens,
                                          mesh, order=order, **kw)
    link = fused_hidden(fused_eng.model, params, fcache, x)
    torch.cuda.synchronize()
    tol = PERSISTENT_MAIN_TOL
    shares = {"x": x_share(torch, got, want, tol["x"]),
              "pool": max(x_share(torch, cache.k, rk, tol["pool"]),
                          x_share(torch, cache.v, rv, tol["pool"]))}
    yardstick = {"x": x_share(torch, link, want, tol["x"]),
                 "pool": max(x_share(torch, fcache.k, rk, tol["pool"]),
                             x_share(torch, fcache.v, rv, tol["pool"]))}
    del fcache
    jk, jv = before[0].clone(), before[1].clone()
    yardstick["x_plain_jax_order"] = x_share(torch, PD.reference_decode_step(
        x, sp, jk, jv, cache.block_table, cache.seq_lens, mesh, order="jax", **kw)[0], want,
        tol["x"])
    del jk, jv
    err = (got.float() - want.float()).abs().max().item()
    check(max(shares.values()) <= 1.0, f"K16 main row: {shares} of its limit from plain")
    # planted faults: every token one slot on; one rank's o-projection
    # partial left out at one layer (required at layer 0; at later layers a
    # reading: see PERSISTENT_MAIN_TOL)
    faults = {"token_one_slot_on": x_share(torch, moved_token(
        torch, cache.k, before[0], cache.block_table, cache.seq_lens,
        cache.k.shape[-2], L), rk, tol["pool"])}
    if n > 1:
        for layer in (0, 1, L // 2, L - 1):
            bad = dropped_partial_step(PD, x, sp, before, cache, mesh, layer, kw, order)
            faults[f"o_partial_left_out@{layer}"] = x_share(torch, bad, want, tol["x"])
    for key in ("token_one_slot_on", "o_partial_left_out@0"):
        if key in faults:
            check(faults[key] >= FAULT_MARGIN, f"K16 main row: the planted fault {key} is only "
                                               f"{faults[key]:.3g} of the limit away")
    del rk, rv
    check(pads_at_rest(), "a signal pad is not at rest after K16's main row")
    # the one-layer check at full width: layer L - 1, fed the plain hidden
    # state entering it
    head = PD.stack_decode_params(types.SimpleNamespace(layers=params.layers[:L - 1]))
    x_last = PD.reference_decode_step(x, head, before[0][:L - 1].clone(),
                                      before[1][:L - 1].clone(), cache.block_table,
                                      cache.seq_lens, mesh, order=order, **kw)[0]
    last = PD.stack_decode_params(types.SimpleNamespace(layers=params.layers[L - 1:]))
    one_layer = {f: persistent_one_layer(torch, PD, x_last, last, (before[0][L - 1:],
                                                                   before[1][L - 1:]),
                                         cache, mesh, f, kw) for f in ("stream", "ring")}
    del head, last, before
    kern = lambda: PD.persistent_decode_step(x, sp, cache.k, cache.v, cache.block_table,  # noqa
                                             cache.seq_lens, mesh, **kw)
    _, ms = perf_func(kern, iters=10)

    def plain():
        pk, pv = cache.k.clone(), cache.v.clone()
        return PD.reference_decode_step(x, sp, pk, pv, cache.block_table, cache.seq_lens, mesh,
                                        order=order, **kw)

    _, plain_ms = perf_func(plain, iters=2, warmup_iters=1)
    # the chain is ~1000 launches a step, enqueued slower than they run: its
    # device time is the sum of its kernels' times in a trace
    chain_ms = device_kernel_ms(torch, lambda: fused_eng.model.decode(params, fused_eng.cache, tok),
                                steps=4)
    weights = sum(nbytes(*[w for w in (lp.ln1, lp.ln2, lp.attn.wqkv, lp.attn.wo, lp.attn.q_norm,
                                      lp.attn.k_norm, lp.mlp.gate_up, lp.mlp.down)
                           if w is not None]) for lp in params.layers)
    pos = int(cache.seq_lens[:b].sum())
    kv = L * 2 * pos * c.num_kv_heads * c.head_dim * 2            # K and V prefixes, bf16
    fn_bytes = weights + kv + 2 * nbytes(x) + L * 2 * b * c.num_kv_heads * c.head_dim * 2
    cost = costs.persistent_decode(L, b, c.hidden, c.num_heads // n, c.num_kv_heads // n,
                                   pos // b, c.head_dim, c.intermediate // n, n, c.dtype)
    bound_ms, bound_by = bound(n * cost.flops, fn_bytes, H100_BF16_FLOPS)
    joins = PD.step_joins(form, L, n)
    return dict(
        name=f"persistent_decode[tp{n}]", route="cuda", source=PERSISTENT_SOURCE,
        replaces="triton_distributed_tpu/ops/persistent_decode.py:368", max_abs_err=err,
        k16_form=form, plain_order=order,
        share_of_limit=shares, yardstick_share_of_limit=yardstick,
        faulty_share_of_limit=faults, tol=PERSISTENT_MAIN_TOL, one_layer=one_layer,
        ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, library=None,
        chain_ms=chain_ms, chain=f"the device time of one tp = {n} 'fused' step",
        flops=n * cost.flops, function_bytes=fn_bytes, joins_per_step=joins,
        ms_beyond_bound_per_join=(ms - bound_ms) / joins,
        shape=f"Qwen3-8B n={n} B={b} L={L} position ~{pos // b} bf16",
        counter="persistent_decode", form=(n, L, b, c.hidden))


def persistent_one_layer(torch, PD, x, sp, pools, cache, mesh, form: str, kw) -> dict:
    """K16 in ``form`` on a one-layer table at full width (``sp``, the
    layer's pools ``pools``, fed ``x``, the plain hidden state entering the
    layer) within PERSISTENT_ONE_LAYER_TOL of the plain one-layer step in the
    form's order; every token appended one slot on (a planted fault) at
    least FAULT_MARGIN limits away.  At n > 1 rank 1's o partial left out
    must fail that limit, and each rank's o partial must be present once in
    x_out within PERSISTENT_PRESENCE_TOL, where rank 1's partial left out
    and counted twice (planted faults) land FAULT_MARGIN limits away."""
    tol = PERSISTENT_ONE_LAYER_TOL
    order = plain_order(form)
    n = 1 if mesh is None else mesh.shape["tp"]
    pk, pv = pools[0].clone(), pools[1].clone()
    rk, rv = pools[0].clone(), pools[1].clone()
    got = PD._launch(x, sp, pk, pv, cache.block_table, cache.seq_lens,
                     mesh or PD._one_rank_mesh(x.device), "tp", form=form,
                     sm_scale=pk.shape[-1] ** -0.5, soft_cap=0.0, **kw)
    want = PD.reference_decode_step(x, sp, rk, rv, cache.block_table, cache.seq_lens, mesh,
                                    order=order, **kw)[0]
    torch.cuda.synchronize()
    check(pads_at_rest(), f"a signal pad is not at rest after K16's {form} one-layer check")
    shares = {"x": x_share(torch, got, want, tol["x"]),
              "pool": max(x_share(torch, pk, rk, tol["pool"]), x_share(torch, pv, rv, tol["pool"]))}
    faults = {"token_one_slot_on": x_share(torch, moved_token(
        torch, pk, pools[0], cache.block_table, cache.seq_lens, pk.shape[-2], 1), rk, tol["pool"])}
    check(max(shares.values()) <= 1.0,
          f"K16 {form} one layer at full width: {shares} of PERSISTENT_ONE_LAYER_TOL from plain")
    check(faults["token_one_slot_on"] >= FAULT_MARGIN,
          f"K16 {form} one layer: the planted fault token_one_slot_on is only "
          f"{faults['token_one_slot_on']:.3g} of the limit away")
    out = {"share_of_limit": shares, "faulty_share_of_limit": faults, "tol": tol}
    if n > 1:
        def step(rank, scale):
            return dropped_partial_step(PD, x, sp, pools, cache, mesh, 0, kw, order,
                                        rank=rank, scale=scale)

        def presence(y, g):   # |<y - want, g> / <g, g>| over the limit
            d = (y.float() - want.float()).flatten().double()
            return abs(float(d @ g / (g @ g))) / PERSISTENT_PRESENCE_TOL

        bad = step(1, 0.0)
        faults["o_partial_left_out"] = x_share(torch, bad, want, tol["x"])
        check(faults["o_partial_left_out"] > 1.0,
              f"K16 {form} one layer: rank 1's o partial left out is within the limit "
              f"({faults['o_partial_left_out']:.3g} of it)")
        gs = [(want.float() - (bad if r == 1 else step(r, 0.0)).float()).flatten().double()
              for r in range(n)]
        out["presence_share_of_limit"] = [presence(got, g) for g in gs]
        faults["presence_o_partial_left_out"] = presence(bad, gs[1])
        faults["presence_o_partial_twice"] = presence(step(1, 2.0), gs[1])
        check(max(out["presence_share_of_limit"]) <= 1.0,
              f"K16 {form} one layer: a rank's o partial is not in x_out once: "
              f"{out['presence_share_of_limit']} of PERSISTENT_PRESENCE_TOL")
        for key in ("presence_o_partial_left_out", "presence_o_partial_twice"):
            check(faults[key] >= FAULT_MARGIN, f"K16 {form} one layer: the planted fault {key} "
                                               f"is only {faults[key]:.3g} of the limit away")
        out["presence_tol"] = PERSISTENT_PRESENCE_TOL
    return out


def to_cpu(torch, obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, list):
        return [to_cpu(torch, x) for x in obj]
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: to_cpu(torch, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def phase_parity(tt, torch) -> None:
    """Full width at 2 layers in f32: card (kernels) vs CPU (plain versions)."""
    c = dataclasses.replace(tt.QWEN3_8B, num_layers=2, dtype=torch.float32,
                            max_length=256)
    dev = torch.device("cuda")
    b, s, gen = 2, 128, 8
    gpu = tt.Qwen3(c, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(SEED + 3))
    cpu = tt.Qwen3(c, device="cpu")
    cparams = to_cpu(torch, params)
    ids = torch.randint(0, c.vocab, (b, s), generator=torch.Generator().manual_seed(SEED + 4))
    gcache = tt.init_cache(c.num_layers, b, c.num_kv_heads, c.max_length, c.head_dim,
                           c.dtype, device=dev)
    ccache = tt.init_cache(c.num_layers, b, c.num_kv_heads, c.max_length, c.head_dim,
                           c.dtype, device="cpu")
    glog, _ = gpu.prefill(params, gcache, ids.to(dev))
    clog, _ = cpu.prefill(cparams, ccache, ids)
    glog = glog.cpu()
    err = (glog - clog).abs()
    ok_logits = bool((err <= PARITY_TOL + PARITY_TOL * clog.abs()).all())
    out = {"phase": "parity", "config": "Qwen3-8B width, 2 layers, f32",
           "batch": b, "prompt": s, "new_tokens": gen,
           "prefill_logits_max_abs_err": err.max().item(), "tol": PARITY_TOL,
           "logits_ok": ok_logits}
    for layout in ("contiguous", "paged"):
        tg = tt.Engine(gpu, params, batch=b, cache_layout=layout).generate(ids, gen).cpu()
        tc = tt.Engine(cpu, cparams, batch=b, cache_layout=layout).generate(ids, gen)
        out[f"tokens_equal_{layout}"] = bool(torch.equal(tg, tc))
    emit(out)
    check(ok_logits, f"prefill logits differ card vs CPU by {err.max().item()}")
    check(out["tokens_equal_contiguous"] and out["tokens_equal_paged"],
          "greedy tokens differ between the card and the CPU")

    # the new modes, each from one cache state on both sides: a prefill on
    # the CPU, copied to the card.  Then greedy decode steps, the CPU's token
    # fed to both sides, every step's logits within PARITY_TOL.  An int8
    # cache is copied to the card again, codes and scales, before every
    # step: the two sides' K/V differ in their last bits (summation order),
    # so a value that lies within that distance of a rounding tie takes
    # codes one apart, and these would pile up step after step.  Each step's
    # codes are held to at most one apart before the copy.
    def prefilled(kv_dtype):
        cache = tt.init_paged_cache(c.num_layers, b, c.num_kv_heads, c.max_length,
                                    c.head_dim, c.dtype, page_size=PAGE, device="cpu",
                                    kv_dtype=kv_dtype)
        logits, cache = cpu.prefill(cparams, cache, ids)
        return cache, logits[:, -1].argmax(-1).to(torch.int32)

    def tensors(cache):
        return [getattr(cache, f.name) for f in dataclasses.fields(cache)
                if getattr(cache, f.name) is not None]

    def copy(cache, where):
        return dataclasses.replace(cache, **{
            f.name: getattr(cache, f.name).to(where, copy=True)
            for f in dataclasses.fields(cache) if getattr(cache, f.name) is not None})

    start = {kv: prefilled(kv) for kv in (None, "int8")}
    for label, mode, kv_dtype in (("paged+fused", "fused", None),
                                  ("paged+int8", "psum", "int8"),
                                  ("paged+int8+fused", "fused", "int8"),
                                  ("paged+persistent", "persistent", None)):
        card, host = (tt.Qwen3(c, device=w, decode_mode=mode) for w in (dev, "cpu"))
        ccache = copy(start[kv_dtype][0], "cpu")
        gcache = copy(ccache, dev)
        tok = start[kv_dtype][1]
        steps, share, ok, same, code_gap = [], 0.0, True, True, 0
        for _ in range(gen):
            if kv_dtype:
                for g_, c_ in zip(tensors(gcache), tensors(ccache)):
                    g_.copy_(c_)
            glog = card.decode(params, gcache, tok.to(dev))[0].cpu()
            clog = host.decode(cparams, ccache, tok)[0]
            err = (glog - clog).abs()
            limit = PARITY_TOL + PARITY_TOL * clog.abs()
            ok = ok and bool((err <= limit).all())
            # the largest error as a share of its element's tolerance
            share = max(share, (err / limit).max().item())
            same = same and torch.equal(glog.argmax(-1), clog.argmax(-1))
            tok = clog.argmax(-1).to(torch.int32)
            differing = None
            if kv_dtype:
                differing = 0
                for g_, c_ in ((gcache.k, ccache.k), (gcache.v, ccache.v)):
                    gap = (g_.cpu().int() - c_.int()).abs()
                    differing += int((gap > 0).sum())
                    code_gap = max(code_gap, int(gap.max()))
            steps.append([err.max().item(), differing])
        worst = max(e for e, _ in steps)
        # per step: the logits' largest error, and the int8 codes that
        # differ card vs CPU after it
        emit({"phase": "parity", "mode": label, "decode_steps": gen,
              "decode_logits_max_abs_err": worst, "tol": PARITY_TOL,
              "worst_share_of_tol": share, "steps": steps,
              "int8_codes_max_gap": code_gap if kv_dtype else None,
              "logits_ok": ok, "tokens_equal": same})
        check(ok, f"{label}: decode logits differ card vs CPU by {worst}")
        check(same, f"{label}: greedy tokens differ between the card and the CPU")
        check(code_gap <= 1, f"{label}: int8 codes differ card vs CPU by {code_gap}")


def clone_cache(torch, cache):
    """A copy of a cache's tensors, where they are."""
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone() for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


def phase_parity_tp(tt, torch) -> None:
    """Full width at 2 layers in f32, batch 4, prompt 128, 8 new tokens: the
    port at tp = 4 on the card (K12-K14 and the other kernels) against the
    port at tp = 4 on the CPU (plain versions) and the port at tp = 1 on the
    card, from the same weights (one seed; tp = 4 shards the tp = 1 draw).
    Prefill logits, then every decode step's logits in every served mode,
    each mode from the prefill's cache state on every side, the CPU's greedy
    token fed to all three: logits within PARITY_TOL (absolute plus
    relative), greedy tokens equal."""
    t0 = time.perf_counter()
    c = dataclasses.replace(tt.QWEN3_8B, num_layers=2, dtype=torch.float32, max_length=256)
    dev = torch.device("cuda")
    b, s, gen = BATCH, 128, 8
    mesh, cmesh = tt.make_mesh({"tp": COLL_TP}), tt.make_mesh({"tp": COLL_TP}, device="cpu")
    card4 = tt.Qwen3(c, mesh=mesh)
    params4 = card4.init(torch.Generator(device=dev).manual_seed(SEED + 3))
    card1 = tt.Qwen3(c, device=dev)
    params1 = card1.init(torch.Generator(device=dev).manual_seed(SEED + 3))
    cpu4 = tt.Qwen3(c, mesh=cmesh)
    cparams4 = to_cpu(torch, params4)
    ids = torch.randint(0, c.vocab, (b, s), generator=torch.Generator().manual_seed(SEED + 4))
    sides = {"card tp=4": (card4, params4, 4, dev), "cpu tp=4": (cpu4, cparams4, 4, "cpu"),
             "card tp=1": (card1, params1, 1, dev)}

    def compare(logs: dict, what: str) -> dict:
        """Each card side's largest |logit error| against the CPU's; fails
        past PARITY_TOL or on another greedy token."""
        ref = logs["cpu tp=4"]
        limit = PARITY_TOL + PARITY_TOL * ref.abs()
        errs = {}
        for name in ("card tp=4", "card tp=1"):
            err = (logs[name] - ref).abs()
            errs[name] = err.max().item()
            check(bool((err <= limit).all()), f"{what}: {name} differs from cpu tp=4 by "
                                              f"{errs[name]}")
            check(torch.equal(logs[name].argmax(-1), ref.argmax(-1)),
                  f"{what}: {name}'s greedy tokens differ from cpu tp=4's")
        return errs

    for layout, modes in (("contiguous", ("psum", "fused", "persistent")),
                          ("paged", ("psum", "ar", "gemm_ar", "fused", "persistent"))):
        start, logs = {}, {}
        for name, (model, params, tp, where) in sides.items():
            cache = (tt.init_paged_cache(c.num_layers, b, c.num_kv_heads, c.max_length,
                                         c.head_dim, c.dtype, page_size=PAGE, device=where, tp=tp)
                     if layout == "paged" else
                     tt.init_cache(c.num_layers, b, c.num_kv_heads, c.max_length, c.head_dim,
                                   c.dtype, device=where, tp=tp))
            lg, cache = model.prefill(params, cache, ids.to(where))
            logs[name], start[name] = lg[:, -1].cpu(), cache
        emit({"phase": "parity_tp", "layout": layout, "what": "prefill",
              "max_abs_err_vs_cpu_tp4": compare(logs, f"{layout} prefill"), "tol": PARITY_TOL})
        for mode in modes:
            models = {name: tt.Qwen3(c, decode_mode=mode, **(
                {"mesh": m.mesh} if m.tp > 1 else {"device": m.device}))
                for name, (m, *_) in sides.items()}
            caches = {name: clone_cache(torch, start[name]) for name in sides}
            tok = logs["cpu tp=4"].argmax(-1).to(torch.int32)
            worst = dict.fromkeys(("card tp=4", "card tp=1"), 0.0)
            for step in range(gen):
                step_logs = {}
                for name, (_, params, _, where) in sides.items():
                    lg, caches[name] = models[name].decode(params, caches[name], tok.to(where))
                    step_logs[name] = lg.cpu()
                for name, e in compare(step_logs, f"{layout} {mode} step {step}").items():
                    worst[name] = max(worst[name], e)
                tok = step_logs["cpu tp=4"].argmax(-1).to(torch.int32)
            emit({"phase": "parity_tp", "layout": layout, "mode": mode, "decode_steps": gen,
                  "max_abs_err_vs_cpu_tp4": worst, "tol": PARITY_TOL, "tokens_equal": True})
            if mode in ("fused", "persistent") and layout == "paged":
                # decode_multi (the argmax fed back on the device) against gen
                # single steps fed their own argmax, on the card at tp = 4 and 1
                same = {}
                for name in ("card tp=4", "card tp=1"):
                    model, params, _, where = models[name], sides[name][1], None, sides[name][3]
                    tok0 = logs["cpu tp=4"].argmax(-1).to(torch.int32).to(where)
                    multi, _ = model.decode_multi(params, clone_cache(torch, start[name]), tok0,
                                                  gen)
                    single, cache, tok = [], clone_cache(torch, start[name]), tok0
                    for _ in range(gen):
                        lg, cache = model.decode(params, cache, tok)
                        tok = lg.argmax(-1).to(torch.int32)
                        single.append(tok)
                    same[name] = bool(torch.equal(multi, torch.stack(single)))
                    check(same[name], f"{mode} {name}: decode_multi differs from {gen} single "
                                      "steps")
                emit({"phase": "parity_tp", "layout": layout, "mode": mode,
                      "decode_multi_equals_single_steps": same})
    emit({"phase": "parity_tp_done", "config": "Qwen3-8B width, 2 layers, f32, tp = 4",
          "batch": b, "prompt": s, "seconds": time.perf_counter() - t0})
    del sides, params4, params1, cparams4, card4, card1, cpu4
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# tutorial 14's path: the overlap probe (K19), bucketed serving as CUDA
# graphs, link calibration

PROBE_SOURCE = "triton_distributed_tpu_torch/csrc/overlap_probe.cu"
PROBE_MAIN = 4096                 # bench.py's overlap shape, 4096^3 bf16
PROBE_EDGE = (1000, 1000)         # m and n off every tile
AOT_BUCKETS = [768, 1024]
AOT_PROMPTS = (1024, 700)         # an exact fit, and 700 padded to 768
# the replayed prefill at 700, padded to 768, against the eager prefill at
# 700: the same kernels on the first 700 positions, but cuBLAS may choose
# other tiles for 4 x 768 rows than for 4 x 700, which moves bf16 roundings
# of the activations; through 36 layers that stays below 2**-4 on logits of
# magnitude ~1-5 (the tokens are held equal besides)
PAD_PREFILL_TOL = 2.0 ** -4
AOT_MODES_TP1 = ("psum", "fused")
AOT_MODES_TP4 = ("psum", "ar", "gemm_ar", "fused")


def probe_limits(torch, mode: str, a, b, tile, want):
    """Per-element limits of K19 against its plain version: fused and mxu
    K6's (BF16_TOL + 2**-7 |plain| in bf16, F32_TOL in f32); dma one output
    ulp at the plain value plus the reordering of its 2048-term f32 sum
    (2048 x 2**-24 x the sum of the terms' magnitudes)."""
    from triton_distributed_tpu_torch.tools import overlap as OV

    if mode != "dma":
        atol, rtol = k6_limits(torch, want.dtype)
        return atol + rtol * want.float().abs()
    mant = 7 if want.dtype == torch.bfloat16 else 23
    w = want.float().abs().clamp_min(torch.finfo(want.dtype).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - mant)
    mag = OV.dma_ref(a.abs(), b.abs(), tile).float()
    return ulp + 2048 * 2.0 ** -24 * mag


def phase_probe_cases(tt, torch) -> None:
    """K19's three modes against their plain versions: m and n off the tile
    (1000 x 1000), k = bk and 3 bk, bf16 and f32, every built tile; and a
    control that must miss: an mxu probe reading A's block (0, 1)."""
    from triton_distributed_tpu_torch.tools import overlap as OV

    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for tile in OV.BUILT_TILES[dtype]:
            for k in (tile[2], 3 * tile[2]):
                m, n = PROBE_EDGE
                a, b = k6_operands(torch, gen, m, k, n, dtype)
                fns = OV.overlap_kernels(m, n, k, bm=tile[0], bn=tile[1], bk=tile[2],
                                         dtype=dtype)
                for mode, fn in zip(OV.MODES, fns):
                    got = fn(a, b)
                    want = getattr(OV, f"{mode}_ref")(a, b, tile)
                    limit = probe_limits(torch, mode, a, b, tile, want)
                    share = ((got.float() - want.float()).abs() / limit).max().item()
                    case = dict(dtype=str(dtype), tile=list(tile), m=m, n=n, k=k, mode=mode,
                                max_abs_err=(got.float() - want.float()).abs().max().item(),
                                worst_share_of_limit=share)
                    if mode == "mxu" and k > tile[2]:
                        shifted = torch.cat([a[:, tile[2]:], a[:, :tile[2]]], dim=1)
                        wrong = OV.mxu_ref(shifted, b, tile)
                        case["control_share_of_limit"] = (
                            (got.float() - wrong.float()).abs() / limit).max().item()
                    results.append(case)
    torch.cuda.synchronize()
    for case in results:
        emit({"phase": "probe_case", **case})
    bad = [c for c in results if not c["worst_share_of_limit"] <= 1.0]
    check(not bad, f"{len(bad)} overlap probe cases disagree with their plain versions: {bad[:3]}")
    controls = [c["control_share_of_limit"] for c in results if "control_share_of_limit" in c]
    check(controls and min(controls) >= FAULT_MARGIN,
          f"the mxu probe reading block (0, 1) is not told apart: {controls}")


def interleaved_ms(torch, thunks: dict, rounds: int = 5, iters: int = 10) -> dict:
    """Median over ``rounds`` of each thunk's CUDA-event median (perf_func),
    the thunks timed in turns, the order reversed every other round."""
    import statistics

    from triton_distributed_tpu_torch.core.utils import perf_func

    samples = {name: [] for name in thunks}
    for r in range(rounds):
        order = list(thunks.items())
        for name, fn in (order[::-1] if r % 2 else order):
            samples[name].append(perf_func(fn, iters=iters, warmup_iters=1)[1])
    return {name: statistics.median(v) for name, v in samples.items()}


def probe_main_rows(tt, torch) -> tuple[dict, dict]:
    """K19 at bench.py's 4096^3 bf16 with its default tile: the three modes
    timed interleaved (the path: counted), ``hidden_pct``, each beside its
    bound, its plain version, K6 at its default tile and torch.matmul; then
    the collective decomposition of bench.py's overlap_collective at tp = 4:
    K12 (qkv, gate_up) against the two-way K9 and K12's own main loop alone
    on the gathered rows (``comm/launch.py::loop_product``).
    Returns the rows and the path's launches by form."""
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.launch import loop_product
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import ag_gemm as AG
    from triton_distributed_tpu_torch.ops.matmul import DEFAULT_TILES, matmul
    from triton_distributed_tpu_torch.tools import overlap as OV

    s = PROBE_MAIN
    gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
    a, b = k6_operands(torch, gen, s, s, s, torch.bfloat16)
    tile = OV.DEFAULT_TILES[torch.bfloat16]
    fns = dict(zip(OV.MODES, OV.overlap_kernels(s, s, s, dtype=torch.bfloat16)))
    torch.cuda.synchronize()
    tt.reset_launch_counts()
    times = interleaved_ms(torch, {mode: (lambda f=f: f(a, b)) for mode, f in fns.items()})
    torch.cuda.synchronize()
    forms = {key: n for key, n in tt.launch_forms().items() if key[0] == "overlap_probe"}
    pct = OV.hidden_pct(times["fused"], times["dma"], times["mxu"])
    _, k6_ms = perf_func(lambda: matmul(a, b, config=DEFAULT_TILES[a.dtype]), iters=10)
    _, lib_ms = perf_func(lambda: torch.matmul(a, b), iters=10)
    # each input read once and the output written once; the products' operations
    # (dma runs none); the dma probe's own stream (A read n / bn times, B
    # m / bm times) is printed beside it, not a bound of the function
    flops, fn_bytes = 2 * s ** 3, nbytes(a, b) + s * s * 2
    streamed = nbytes(a) * (s // tile[1]) + nbytes(b) * (s // tile[0]) + s * s * 2
    bounds = {mode: bound(0 if mode == "dma" else flops, fn_bytes, H100_BF16_FLOPS)
              for mode in fns}
    rows = {}
    for mode, fn in fns.items():
        got = fn(a, b)
        want = getattr(OV, f"{mode}_ref")(a, b, tile)
        limit = probe_limits(torch, mode, a, b, tile, want)
        share = ((got.float() - want.float()).abs() / limit).max().item()
        check(share <= 1.0, f"overlap_probe[{mode}] at {s}^3: {share:.3g} of its limit")
        _, plain_ms = perf_func(lambda m=mode: getattr(OV, f"{m}_ref")(a, b, tile), iters=3)
        name = f"overlap_probe[{mode}]"
        rows[name] = dict(
            name=name, route="cuda", source=PROBE_SOURCE,
            replaces="triton_distributed_tpu/tools/overlap.py:49",
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            worst_share_of_limit=share, ms=times[mode], plain_ms=plain_ms,
            bound_ms=bounds[mode][0], bound_by=bounds[mode][1],
            library_ms=lib_ms if mode == "fused" else None,
            library="torch.matmul" if mode == "fused" else None,
            k6_ms=k6_ms, hidden_pct=pct, tile=list(tile),
            streamed_ms=streamed / H100_BYTES_PER_S * 1e3 if mode == "dma" else None,
            counter="overlap_probe", form=(mode, s, s, s), shape=f"{s}^3 bf16")
        del got, want, limit
    emit({"phase": "overlap_probe", "fused_ms": times["fused"], "dma_ms": times["dma"],
          "mxu_ms": times["mxu"], "hidden_pct": pct, "k6_ms": k6_ms, "library_ms": lib_ms,
          "tile": list(tile), "launches": {str(k): v for k, v in forms.items()}})
    del a, b
    # the collective decomposition (bench.py:2161-2200) at tp = 4
    n = COLL_TP
    mesh = make_mesh({"tp": n})
    for name, _, m, k, cols, _ in OVERLAP_MAIN[:2]:
        x = torch.randn((n, m // n, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((n, k, cols // n), generator=gen, device="cuda") / k ** 0.5).to(torch.bfloat16)
        gathered = comm.all_gather(x, mesh, method=comm.AllGatherMethod.RING_BIDIR)
        t = interleaved_ms(torch, {
            "fused": lambda: AG.ag_gemm(x, w, mesh),
            "comm": lambda: comm.all_gather(x, mesh, method=comm.AllGatherMethod.RING_BIDIR),
            "gemm": lambda: loop_product(gathered, w)})
        emit({"phase": "overlap_collective", "name": name, "tp": n, "m": m, "k": k,
              "n_cols": cols, "fused_ms": t["fused"], "comm_ms": t["comm"],
              "gemm_ms": t["gemm"], "hidden_pct": OV.hidden_pct(t["fused"], t["comm"], t["gemm"])})
        del x, w, gathered
    gc.collect()
    torch.cuda.empty_cache()
    return rows, forms


def poison(eng) -> None:
    """Replace the model's prefill and decode with functions that raise (JAX
    ``tests/test_engine_aot.py::_poison_jit_paths``): a replayed step must
    not run them."""
    def boom(*a, **k):
        raise AssertionError("an eager model step ran after precompile")

    eng.model.prefill = boom
    eng.model.decode = boom


def unpoison(eng) -> None:
    del eng.model.prefill, eng.model.decode


def replayed_profile(torch, eng, tok, steps: int = 8) -> dict:
    """Host wall time of ``steps`` replayed decode steps (ended by a
    synchronize), and the device kernel time of the same steps from a
    torch.profiler trace; None where the trace shows no kernel."""
    from torch.profiler import ProfilerActivity, profile

    eng.decode_step(tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode_step(tok)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.decode_step(tok)
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel = sum(e.time_range.elapsed_us() for e in ks) / 1e3 / steps if ks else None
    return {"wall_ms": wall, "device_kernel_ms": kernel,
            "idle_share": None if kernel is None else 1.0 - kernel / wall,
            "kernel_launches": len(ks) / steps}


def aot_serve_mode(tt, torch, model, params, label: str, save_dir=None) -> dict:
    """One engine and mode of the bucketed path: eager serve of both
    prompts, precompile, the eager steps poisoned and the counters frozen,
    then replayed serves (twice each), tokens equal; one replayed decode step
    from a given cache state within PARITY_TOL of the eager step, the padded
    prefill within PAD_PREFILL_TOL of the eager one; a profile of replayed
    steps.  Returns what the child and the report need."""
    dev = model.device
    fit, pad = AOT_PROMPTS
    eng = tt.Engine(model, params, batch=BATCH, cache_layout="contiguous")
    prompts = {L: torch.randint(0, model.config.vocab, (BATCH, L), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(300 + L))
               for L in AOT_PROMPTS}
    out = {"label": label, "eager": {}, "replayed": {}}
    eager_tokens, eager_logits = {}, {}
    for L, ids in prompts.items():
        eager_tokens[L], out["eager"][L] = eng.serve(ids, GEN)
        eager_logits[L] = eng.prefill(ids).clone()
    # a cache state: the exact-fit prompt and one step, then the eager step from it
    tok = eager_tokens[fit][:, 0].contiguous()
    eng.prefill(prompts[fit])
    eng.decode_step(tok)
    state = clone_cache(torch, eng.cache)
    eager_step = eng.decode_step(tok).clone()
    t0 = time.perf_counter()
    try:
        manifest = eng.precompile(AOT_BUCKETS, save_dir=save_dir)
    except NotImplementedError as e:
        emit({"phase": "aot_capture", "label": label, "captured": False, "error": str(e),
              "capture_s": time.perf_counter() - t0})
        if model.tp == 1:
            raise
        check(model.decode_mode in str(e), f"{label}: the refusal does not name the mode")
        out["refused"] = str(e)
        return out
    capture_s = time.perf_counter() - t0
    poison(eng)
    before = tt.launch_counts()
    replayed_tokens = {}
    for rep in range(2):
        for L, ids in prompts.items():
            replayed_tokens[L], stats = eng.serve(ids, GEN)
            out["replayed"].setdefault(L, []).append(stats)
    torch.cuda.synchronize()
    after = tt.launch_counts()
    at_rest = pads_at_rest()   # the replayed barriers and rings drain their flags
    for k in ("k", "v", "kv_len"):
        getattr(eng.cache, k).copy_(getattr(state, k))
    replay_step = eng.decode_step(tok)
    step_diff = (replay_step - eager_step).abs().max().item()
    pad_diff = (eng.prefill(prompts[pad]) - eager_logits[pad]).abs().max().item()
    fit_diff = (eng.prefill(prompts[fit]) - eager_logits[fit]).abs().max().item()
    prof = replayed_profile(torch, eng, tok)
    same = {L: bool(torch.equal(replayed_tokens[L], eager_tokens[L])) for L in prompts}
    emit({"phase": "aot_serving", "label": label, "captured": True, "capture_s": capture_s,
          "buckets": manifest["buckets"], "tokens_equal": same,
          "launches_unchanged": before == after, "pads_at_rest": at_rest,
          "decode_step_max_diff": step_diff,
          "prefill_padded_max_diff": pad_diff, "prefill_exact_fit_max_diff": fit_diff,
          "eager": out["eager"], "replayed": out["replayed"], "replayed_profile": prof,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(all(same.values()), f"{label}: replayed tokens differ from eager ones: {same}")
    check(before == after, f"{label}: a kernel wrapper ran during replay")
    check(at_rest, f"{label}: a signal pad is not at rest after the replays")
    check(step_diff <= PARITY_TOL, f"{label}: replayed step {step_diff} from the eager one")
    check(pad_diff <= PAD_PREFILL_TOL, f"{label}: padded prefill {pad_diff} from eager")
    unpoison(eng)
    out.update(tokens=replayed_tokens, prompts=prompts, engine=eng)
    return out


def aot_child(save_dir: str) -> int:
    """Run in a second process by phase_aot_serving: an engine of the same
    seed serves the parent's manifest through ``load_precompiled``, with no
    nvcc run (the library is on disk) and the eager steps poisoned; writes
    its tokens beside the manifest."""
    import torch

    import triton_distributed_tpu_torch as tt
    from triton_distributed_tpu_torch.core import build

    _, log = build.build()
    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    dev = torch.device("cuda")
    params = tt.Qwen3(c, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    eng = tt.Engine(tt.Qwen3(c, device=dev), params, batch=BATCH)
    t0 = time.perf_counter()
    manifest = eng.load_precompiled(save_dir)
    load_s = time.perf_counter() - t0
    poison(eng)
    prompts = torch.load(Path(save_dir) / "prompts.pt")
    tokens = {L: eng.generate(ids.to(dev), GEN).cpu() for L, ids in prompts.items()}
    torch.save(tokens, Path(save_dir) / "child_tokens.pt")
    emit({"phase": "aot_child", "nvcc_ran": bool(log), "buckets": manifest["buckets"],
          "load_precompiled_s": load_s})
    return 0


def manifest_refusals(tt, torch, model, params, save_dir: Path) -> None:
    """A manifest of another batch, or of another config, raises naming the
    field, before anything is captured."""
    good = json.loads((save_dir / "aot_manifest.json").read_text())
    cases = (("batch", dict(good, batch=BATCH + 1), "batch"),
             ("config", dict(good, arch={**good["arch"], "model_config": {
                 **good["arch"]["model_config"], "num_layers": 35}}), "num_layers"))
    for what, manifest, field in cases:
        bad = save_dir / f"bad_{what}"
        bad.mkdir(exist_ok=True)
        (bad / "aot_manifest.json").write_text(json.dumps(manifest))
        eng = tt.Engine(model, params, batch=BATCH)
        try:
            eng.load_precompiled(str(bad))
            raise PhaseError(f"a manifest of another {what} was accepted")
        except ValueError as e:
            emit({"phase": "aot_manifest_refused", "what": what, "error": str(e)})
            check(field in str(e), f"the refusal of another {what} does not name {field}")
        del eng


def phase_calibration(tt, torch) -> None:
    """Tutorial 14's part 2 with a throwaway TDT_LINKCAL_CACHE: a measured
    10 us hop moves a 1 MiB shard's gather from the ring to the push."""
    from triton_distributed_tpu_torch.comm import allgather as AGm
    from triton_distributed_tpu_torch.tools import calibrate as cal

    path = Path(__file__).resolve().parent / "build" / "linkcal_smoke.json"
    path.unlink(missing_ok=True)
    old = os.environ.get("TDT_LINKCAL_CACHE")
    os.environ["TDT_LINKCAL_CACHE"] = str(path)
    cal.invalidate_cache()
    try:
        probe = 1 << 20
        cold = AGm.choose_method(probe, 8)
        cal.save_calibration(cal.LinkCalibration(ici_gbps=186.0, ici_hop_us=10.0,
                                                 device_kind="smoke", n_devices=8))
        warm = AGm.choose_method(probe, 8)
        emit({"phase": "calibration", "cold": cold.name, "calibrated": warm.name,
              "push_bytes_threshold": cal.push_bytes_threshold()})
        check(cold == AGm.AllGatherMethod.RING_BIDIR and warm == AGm.AllGatherMethod.PUSH_1SHOT,
              f"choose_method did not flip for 1 MiB: {cold} -> {warm}")
    finally:
        path.unlink(missing_ok=True)
        if old is None:
            os.environ.pop("TDT_LINKCAL_CACHE", None)
        else:
            os.environ["TDT_LINKCAL_CACHE"] = old
        cal.invalidate_cache()


def phase_aot_serving(tt, torch) -> tuple[dict, dict, dict]:
    """Tutorial 14 on the card: K19's cases and main rows, bucketed serving
    of Qwen3-8B (full width and depth, batch 4, the contiguous cache) as
    CUDA graphs at tp = 1 and tp = 4, a second process serving the saved
    manifest, and the calibration's method flip.  Returns K19's rows, the
    path's launches and their forms."""
    import shutil
    import subprocess

    t0 = time.perf_counter()
    phase_probe_cases(tt, torch)
    rows, forms = probe_main_rows(tt, torch)
    launches = {"overlap_probe": sum(forms.values())}
    emit({"phase": "aot_probe_done", "seconds": time.perf_counter() - t0})
    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    dev = torch.device("cuda")
    save_dir = Path(__file__).resolve().parent / "build" / "aot_smoke"
    shutil.rmtree(save_dir, ignore_errors=True)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tt.Qwen3(c, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    for mode in AOT_MODES_TP1:
        model = tt.Qwen3(c, device=dev, decode_mode=mode)
        res = aot_serve_mode(tt, torch, model, params, f"tp1 {mode}",
                             save_dir=str(save_dir) if mode == "psum" else None)
        if mode == "psum":
            torch.save({L: ids.cpu() for L, ids in res["prompts"].items()},
                       save_dir / "prompts.pt")
            parent_tokens = {L: t.cpu() for L, t in res["tokens"].items()}
            manifest_refusals(tt, torch, model, params, save_dir)
        del res
        gc.collect()
    emit({"phase": "aot_tp1_done", "seconds": time.perf_counter() - t1,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    t2 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--aot-child",
                            str(save_dir)], capture_output=True, text=True, timeout=300)
    lines = [ln for ln in child.stdout.splitlines() if '"aot_child"' in ln]
    emit({"phase": "aot_second_process", "rc": child.returncode,
          "seconds": time.perf_counter() - t2, "report": json.loads(lines[-1]) if lines else None})
    check(child.returncode == 0 and lines, f"the second process failed:\n{child.stderr[-3000:]}")
    check(not json.loads(lines[-1])["nvcc_ran"], "the second process ran nvcc")
    got = torch.load(save_dir / "child_tokens.pt")
    check(all(torch.equal(got[L], parent_tokens[L]) for L in parent_tokens),
          "the second process served other tokens than the parent")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = tt.make_mesh({"tp": COLL_TP})
    params = tt.Qwen3(c, mesh=mesh).init(torch.Generator(device=mesh.device).manual_seed(SEED))
    refused = {}
    for mode in AOT_MODES_TP4:
        res = aot_serve_mode(tt, torch, tt.Qwen3(c, mesh=mesh, decode_mode=mode), params,
                             f"tp4 {mode}")
        if "refused" in res:
            refused[mode] = res["refused"]
        del res
        gc.collect()
    emit({"phase": "aot_tp4_done", "seconds": time.perf_counter() - t3, "refused": refused,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_calibration(tt, torch)
    shutil.rmtree(save_dir, ignore_errors=True)
    emit({"phase": "aot_serving_done", "seconds": time.perf_counter() - t0})
    return rows, launches, forms


def main() -> int:
    if sys.argv[1:2] == ["--stalled-rank-child"]:
        return stalled_rank_child(sys.argv[2])
    if sys.argv[1:2] == ["--aot-child"]:
        return aot_child(sys.argv[2])
    here = Path(__file__).resolve().parent
    if not (here / "triton_distributed_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: triton_distributed_tpu_torch/ not found beside the "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the card and "
              "has nothing to report without one", file=sys.stderr)
        return 2
    import triton_distributed_tpu_torch as tt

    # the tuner's winners go to a file of the checkout's build directory
    tune_cache = here / "build" / "autotune_smoke.json"
    tune_cache.unlink(missing_ok=True)
    os.environ["TDT_AUTOTUNE_CACHE"] = str(tune_cache)
    # f32 products in full f32 (the parity phase compares against the CPU)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    try:
        cap = torch.cuda.get_device_capability(0)
        card = tt.card_identity()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "capability": list(cap), "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "card": card})
        check(cap == (9, 0), f"capability {cap}: the kernels are built for sm_90a")
        phase = "build"
        phase_build(tt)
        phase = "kernel_cases"
        phase_kernel_cases(tt, torch)
        phase_fused_cases(tt, torch)
        phase_group_gemm_cases(tt, torch)
        phase_moe_attention_cases(tt, torch)
        phase = "kernels_main"
        rows = phase_kernels_main(tt, torch)
        rows.update(group_gemm_main_rows(tt, torch))
        phase = "local_ops"
        local_rows, local_launches, local_forms = phase_local_ops(tt, torch)
        rows.update(local_rows)
        phase = "collectives"
        coll_rows, coll_launches, coll_forms = phase_collectives(tt, torch)
        rows.update(coll_rows)
        phase = "overlap_cases"
        rows.update(phase_overlap(tt, torch))
        phase = "fused_tp"
        rows.update(phase_fused_tp(tt, torch))
        phase = "persistent_cases"
        phase_persistent_cases(tt, torch)
        phase = "ep_cases"
        phase_ep_cases(tt, torch)
        phase = "serve"
        t0 = time.perf_counter()
        launches, serve_forms, serve_rows = phase_serve(tt, torch)
        rows.update(serve_rows)
        emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})
        phase = "serve_tp"
        tp_launches, tp_forms, tp_rows = phase_serve_tp(tt, torch)
        rows.update(tp_rows)
        phase = "aot_serving"
        aot_rows, aot_launches, aot_forms = phase_aot_serving(tt, torch)
        rows.update(aot_rows)
        phase = "serve_moe"
        t0 = time.perf_counter()
        moe_launches, forms, ep_rows = phase_serve_moe(tt, torch)
        rows.update(ep_rows)
        emit({"phase": "serve_moe_done", "seconds": time.perf_counter() - t0})
        for name, n in [*moe_launches.items(), *local_launches.items(),
                        *coll_launches.items(), *tp_launches.items(), *aot_launches.items()]:
            launches[name] += n
        forms.update(local_forms)
        for key, n in [*coll_forms.items(), *tp_forms.items(), *serve_forms.items(),
                       *aot_forms.items()]:
            forms[key] = forms.get(key, 0) + n
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
        phase = "parity"
        t0 = time.perf_counter()
        phase_parity(tt, torch)
        phase_parity_moe(tt, torch)
        emit({"phase": "parity_done", "seconds": time.perf_counter() - t0})
        phase = "parity_tp"
        phase_parity_tp(tt, torch)
        phase = "parity_ep"
        phase_parity_ep(tt, torch)
        phase = "report"
        kernels = []
        for name, row in rows.items():
            # K5's and K6's rows: the launches of the row's form, as counted
            n = (forms.get((row.get("counter", "grouped_matmul"), row["form"]), 0)
                 if "form" in row else launches.get(row.get("counter", name)))
            check(n > 0, f"{name}: no launch of its form on the main path")
            kernels.append({k: row[k] for k in (
                "name", "route", "source", "replaces")} | {
                "launches": n, **{k: row[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library", "chain_ms", "k6_ms", "hidden_pct", "ring_ms")
                    if k in row}})
        emit({"kernels": kernels})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception as e:  # report the failing phase, then fail the run
        import traceback

        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1


if __name__ == "__main__":
    sys.exit(main())
