#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (triton_distributed_tpu_torch) on one
NVIDIA H100 and check it.

    python3 chip_smoke.py      # needs one Hopper card

Phases, each printing JSON lines; any failure exits non-zero:

1. device   -- CUDA present with capability (9, 0); the card's name and power
               limit as ``nvidia-smi`` prints them.
2. build    -- nvcc builds the kernels from ``triton_distributed_tpu_torch/csrc``.
3. kernels  -- each kernel against its plain PyTorch version on the card:
               small edge cases (f32 and bf16, GQA 1-8, soft cap, qk-norm on
               and off, ragged and empty rows, a position on a page boundary
               and in the table's last slot, shuffled page tables; for K4 the
               pools after the append as well), then the Qwen3-8B main-path
               shapes (B = 4, prompt 1024, cache of 2048, position 1056),
               each timed with CUDA events beside its plain version, its
               bound, and SDPA or (K4) the per-kernel chain it replaces.
4. serve    -- Qwen3-8B at full width and depth with seeded random weights,
               batch 4, max_length 2048: requests of 1024 prompt tokens and 64
               new tokens in five modes (contiguous, paged, paged + fused,
               paged + int8, paged + int8 + fused); the launch counters must
               rise by 36 per prefill (K1) and by 36 per decode step for the
               mode's decode kernel (K2, K3, K4, K3-int8, K4-int8), and by
               nothing for any other kernel.  Then a torch.profiler trace of
               one prefill and eight decode steps per mode: wall vs kernel
               time, idle share, kernel time by class (attention, GEMM,
               other).
5. parity   -- full width at 2 layers in f32, batch 2, prompt 128, 8 new
               tokens: the port on the card (kernels) and on the CPU (plain
               versions) from the same weights give the same logits within
               1e-3 (prefill, and every decode step of the fused, int8 and
               int8 + fused modes, each from one cache state on both sides;
               int8 codes at most one apart, see phase_parity) and the same
               greedy tokens.
6. the kernels line, the card line, and the result line.

The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
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
        if "fused_attn_decode_kernel" in e
        or re.search(r"decode_splitI(f|13__nv_bfloat16)a", e)]})
    build.library()


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
        source=src + "decode_attention.cu",
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


KERNEL_CLASSES = (("attention", ("flash_fwd", "decode_split", "decode_combine",
                                 "fused_attn_decode")),
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


# (label, cache layout, decode mode, kv dtype, the decode step's kernel)
SERVE_MODES = (
    ("contiguous", "contiguous", "psum", None, "decode_attention"),
    ("paged", "paged", "psum", None, "paged_decode_attention"),
    ("paged+fused", "paged", "fused", None, "fused_attn_decode"),
    ("paged+int8", "paged", "psum", "int8", "paged_decode_attention_int8"),
    ("paged+int8+fused", "paged", "fused", "int8", "fused_attn_decode_int8"),
)
REQUESTS = 3


def phase_serve(tt, torch) -> dict:
    """Qwen3-8B, full width and depth, in each serving mode: the main path,
    with the launch counters set to 0 just before each mode's requests and
    read just after; then a profile of one prefill and a few decode steps
    in each mode.  Returns the launches summed over the modes."""
    c = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = tt.Qwen3(c, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    models = {mode: tt.Qwen3(c, device=dev, decode_mode=mode) for mode in ("psum", "fused")}
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", "init_s": time.perf_counter() - t0,
          "param_bytes": torch.cuda.memory_allocated()})
    engines = {}
    totals = dict.fromkeys(tt.launch_counts(), 0)
    for label, layout, mode, kv_dtype, kernel in SERVE_MODES:
        eng = tt.Engine(models[mode], params, batch=BATCH, cache_layout=layout,
                        page_size=PAGE, kv_dtype=kv_dtype)
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
            want[kernel] = GEN * c.num_layers
            emit({"phase": "serve", "layout": label, "request": req, **stats,
                  "launches": delta})
            check(delta == want, f"{label} request {req}: launches {delta}, want {want}")
            check(tuple(tokens.shape) == (BATCH, GEN) and tokens.dtype == torch.int32
                  and int(tokens.min()) >= 0 and int(tokens.max()) < c.vocab,
                  f"{label}: bad tokens {tokens.shape} {tokens.dtype}")
        for k, n in tt.launch_counts().items():
            totals[k] += n
        engines[label] = (eng, ids)
    for label, (eng, ids) in engines.items():
        phase_profile(eng, ids, torch, label)
    del engines, models, params
    torch.cuda.empty_cache()
    return totals


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
                                  ("paged+int8+fused", "fused", "int8")):
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
        phase_fused_cases(tt, torch)
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
                    "library_ms", "chain_ms") if k in row}})
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
