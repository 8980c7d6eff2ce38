#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (triton_distributed_tpu_torch) on one
NVIDIA H100 and check it.

    python3 chip_smoke.py            # needs one Hopper card

Phases, each printing JSON lines; any failure exits non-zero:

1. device   -- CUDA present with capability (9, 0); the card's name and power
               limit as ``nvidia-smi`` prints them.
2. build    -- nvcc builds the kernels from ``triton_distributed_tpu_torch/csrc``.
3. kernels  -- each kernel against its plain PyTorch version on the card:
               small edge cases (f32 and bf16, GQA, soft cap, ragged and empty
               rows, shuffled page tables), then the Qwen3-8B main-path shapes
               (B = 4, prompt 1024, cache of 2048), each timed with CUDA events
               beside its plain version, SDPA and its bound.
4. serve    -- Qwen3-8B at full width and depth with seeded random weights,
               batch 4, max_length 2048: three requests of 1024 prompt tokens
               and 64 new tokens on each cache layout; the launch counters must
               rise by 36 per prefill (K1) and 36 per decode step (K2 or K3).
               Then a torch.profiler trace of one prefill and eight decode
               steps per layout: wall vs kernel time, idle share, kernel time
               by class (attention, GEMM, other).
5. parity   -- full width at 2 layers in f32, batch 2, prompt 128, 8 new
               tokens: the port on the card (kernels) and on the CPU (plain
               versions) from the same weights give the same prefill logits
               within 1e-3 and the same greedy tokens.
6. the kernels line, the card line, and the result line.

The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12     # HBM3
SEED = 0
BATCH, PROMPT, MAX_LEN, GEN, DECODE_POS = 4, 1024, 2048, 64, 1056
BF16_TOL = 2e-2   # |kernel - plain|: outputs are O(1); bf16 keeps 8 bits and
                  # p is rounded at different running maxima in the two
F32_TOL = 1e-4    # summation order only
PARITY_TOL = 1e-3


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
    lines = [ln.strip() for ln in log.splitlines()]
    # ptxas -v: per kernel instantiation, "Compiling entry function '<name>'",
    # a spill line that should read 0 bytes, and "Used N registers"
    spills, entry = [], ""
    for ln in lines:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "bytes spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{entry}: {ln}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(Path(__file__).resolve().parent)),
          "kernels_compiled": sum("Used" in ln and "registers" in ln for ln in lines),
          "max_registers": max([int(ln.split("Used ")[1].split()[0])
                                for ln in lines if "Used " in ln] or [0]),
          "spilling": spills[:8]})
    build.library()


def phase_kernel_cases(tt, torch) -> None:
    """Edge cases at small shapes, both storage types, before the real ones."""
    from triton_distributed_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    results = []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for (b, h, hk, s, d, causal, cap) in (
                (2, 4, 2, 200, 64, True, 0.0), (1, 8, 8, 130, 128, False, 0.0),
                (2, 4, 1, 96, 128, True, 30.0), (1, 2, 2, 64, 64, False, 5.0)):
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
        name="decode_attention", route="cuda", source=src + "decode_attention.cu",
        replaces="triton_distributed_tpu/ops/attention.py:935",
        max_abs_err=err, tol=BF16_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h},{d}) cache ({BATCH},{hk},{MAX_LEN},{d}) bf16 kv_len {DECODE_POS}")

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
        name="paged_decode_attention", route="cuda", source=src + "decode_attention.cu",
        replaces="triton_distributed_tpu/ops/attention.py:1096",
        max_abs_err=err, tol=BF16_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        shape=f"q ({BATCH},{h},{d}) pool ({BATCH * mp},{hk},{ps},{d}) bf16 seq_lens {DECODE_POS}")
    torch.cuda.synchronize()
    for row in rows.values():
        emit({"phase": "kernel_main", **row})
        check(row["max_abs_err"] <= BF16_TOL,
              f"{row['name']} disagrees with its plain version: {row['max_abs_err']}")
    return rows


KERNEL_CLASSES = (("attention", ("flash_fwd", "decode_split", "decode_combine")),
                  ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")))


def phase_profile(eng, ids, torch, layout: str) -> None:
    """Where a prefill and a decode step spend their time: host wall time
    (no profiler), device kernel time by class from a torch.profiler trace,
    and the device's idle share (1 - kernel time / wall time)."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    steps = 8
    tok = eng.prefill(ids).argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
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
             lambda: [eng.decode_step(tok) for _ in range(steps)])):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            thunk()
            torch.cuda.synchronize()
        ks = kernels(prof)
        by_name: dict[str, float] = {}
        for e in ks:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        classes = {"attention": 0.0, "gemm": 0.0, "other": 0.0}
        for name, ms in by_name.items():
            cls = next((c for c, keys in KERNEL_CLASSES
                        if any(k in name for k in keys)), "other")
            classes[cls] += ms
        device_ms = sum(classes.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit({"phase": "profile", "layout": layout, "what": what,
              "wall_ms": walls[what], "device_kernel_ms": device_ms,
              "idle_share": 1.0 - device_ms / walls[what],
              "host_enqueue_ms": enqueue_ms if what == "decode_step" else None,
              "kernel_launches": len(ks) / n,
              "device_ms_by_class": classes,
              "top_kernels_ms": [[name[:60], ms] for name, ms in top]})


def phase_serve(tt, torch) -> dict:
    """Qwen3-8B, full width and depth, both cache layouts; the main path,
    then a profile of one prefill and a few decode steps on each layout."""
    from triton_distributed_tpu_torch.ops import attention as A

    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = tt.Qwen3(c, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", "init_s": time.perf_counter() - t0,
          "param_bytes": torch.cuda.memory_allocated()})
    decode_kernel = {"contiguous": "decode_attention", "paged": "paged_decode_attention"}
    engines = {}
    A.reset_launch_counts()
    for layout in ("contiguous", "paged"):
        eng = tt.Engine(model, params, batch=BATCH, cache_layout=layout, page_size=64)
        for req in range(3):
            ids = torch.randint(0, c.vocab, (BATCH, PROMPT), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(100 + req))
            before = A.launch_counts()
            tokens, stats = eng.serve(ids, GEN)
            torch.cuda.synchronize()
            after = A.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            # serve = a warm-up prefill and decode step, then the timed prefill
            # and GEN - 1 decode steps
            want = {k: 0 for k in delta}
            want["flash_attention"] = 2 * c.num_layers
            want[decode_kernel[layout]] = GEN * c.num_layers
            emit({"phase": "serve", "layout": layout, "request": req, **stats,
                  "launches": delta})
            check(delta == want, f"{layout} request {req}: launches {delta}, want {want}")
            check(tuple(tokens.shape) == (BATCH, GEN) and tokens.dtype == torch.int32
                  and int(tokens.min()) >= 0 and int(tokens.max()) < c.vocab,
                  f"{layout}: bad tokens {tokens.shape} {tokens.dtype}")
        engines[layout] = (eng, ids)
    totals = A.launch_counts()
    for layout, (eng, ids) in engines.items():
        phase_profile(eng, ids, torch, layout)
    del engines, model, params
    torch.cuda.empty_cache()
    return totals


def phase_parity(tt, torch) -> None:
    """Full width at 2 layers in f32: card (kernels) vs CPU (plain versions)."""
    c = dataclasses.replace(tt.QWEN3_8B, num_layers=2, dtype=torch.float32,
                            max_length=256)
    dev = torch.device("cuda")
    b, s, gen = 2, 128, 8
    gpu = tt.Qwen3(c, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(SEED + 3))
    cpu = tt.Qwen3(c, device="cpu")

    def to_cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.cpu()
        if isinstance(obj, list):
            return [to_cpu(x) for x in obj]
        if dataclasses.is_dataclass(obj):
            return type(obj)(**{f.name: to_cpu(getattr(obj, f.name))
                                for f in dataclasses.fields(obj)})
        return obj

    cparams = to_cpu(params)
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


def main() -> int:
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
        phase = "kernels_main"
        rows = phase_kernels_main(tt, torch)
        phase = "serve"
        launches = phase_serve(tt, torch)
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
        phase = "parity"
        phase_parity(tt, torch)
        phase = "report"
        kernels = []
        for name, row in rows.items():
            kernels.append({k: row[k] for k in (
                "name", "route", "source", "replaces")} | {
                "launches": launches[name], **{k: row[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}})
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
