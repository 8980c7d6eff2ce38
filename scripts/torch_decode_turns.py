"""Two checkouts on one card, in turns: kernel times and served decode steps.

    python3 scripts/torch_decode_turns.py rows TREE LABEL      # one checkout's kernel rows
    python3 scripts/torch_decode_turns.py served TREE LABEL    # its served decode steps
    python3 scripts/torch_decode_turns.py compare LABEL_A LABEL_B

TREE is the root of a checkout (this one, or a parent unpacked with ``git
archive`` into a directory ``.gitignore`` lists); its package and its
``chip_smoke.py`` are imported from there, and its kernels are built there.
Run the two in turns, parent, change, change, parent, in one call, so that
both meet the same card, clocks and neighbours:

    for t in PARENT . . PARENT; do
      python3 scripts/torch_decode_turns.py rows $t LABEL_i
      python3 scripts/torch_decode_turns.py served $t LABEL_i
    done
    python3 scripts/torch_decode_turns.py compare parent_1 change_2

``rows`` prints one JSON line, {"tree", "rows": {name: ms}}: every row of
``chip_smoke.py``'s ``phase_kernels_main`` (K1-K4) and of its GEMM,
collective, overlap, fused and probe main rows (the tree's own), and, timed
here with CUDA events, K7's three state forms at the Qwen3-8B decode shape,
K2 and K3 in f32 and at D = 64 (the split + combine pass), and one step of
K16 over 4 layers of Qwen3-8B at tp = 1 and tp = 4 (co-located ranks).
Rows ending in "host us" are host microseconds a call of the served bf16
forms of K2 (int and 0-d device length) and K3 (bf16 and int8 pages): the
time to enqueue 100 calls back to back, which the launch queue holds.

``served`` builds Qwen3-8B (tp = 1: contiguous, paged, int8 pages; tp = 4:
contiguous, paged; int8 pages are served at tp = 1 only) and Qwen3-30B-A3B
(paged) at full width and 4 layers in bf16 from one seed, prefills
1024-token prompts (B = 4), then runs 8 decode steps on tokens drawn from a
seed (the same on both sides, whatever the logits), saving every step's
logits under build/turns/ (git-ignored: they are large); then it times 8
more eager steps on the host's clock (the wall a step, synchronised at the
end, and the host's time to enqueue them) and profiles 8 more: device
kernel ms and kernel launches a step, and the decode attention kernels'
launches by name.  The same bf16 weights,
cast to f32 (exact), then serve the same prompts and tokens in f32 (K2/K3's
split + combine pass, the same in both trees): the reference both trees are
held to.  It prints {"tree", "served": {case: {...}}}.  ``compare`` holds
B's logits to A's and each to the f32 run, the largest difference over the
largest |logit| (a bf16 decode's limit is 2**-6 of it) at the first step
and over all 8, and counts the steps whose greedy tokens agree.
"""
import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "turns"
B, PROMPT, MAX_LEN, STEPS, LAYERS = 4, 1024, 2048, 8, 4


def load(tree: str):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.environ["TDT_AUTOTUNE_CACHE"] = os.path.join(tree, "build", "autotune_turns.json")
    import torch

    import chip_smoke as cs
    import triton_distributed_tpu_torch as tt

    assert tt.__file__.startswith(tree) and cs.__file__.startswith(tree), (tt.__file__, tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, cs, tt


def rows(tree: str, label: str) -> None:
    torch, cs, tt = load(tree)
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import attention as A
    from triton_distributed_tpu_torch.ops import persistent_decode as PD

    out = {}
    for f in (cs.phase_kernels_main, cs.group_gemm_main_rows, cs.collective_main_rows,
              cs.overlap_main_rows, cs.fused_tp_main_rows, cs.probe_main_rows):
        r = f(tt, torch)
        r = r[0] if isinstance(r, tuple) else r
        out.update({k: v["ms"] for k, v in r.items() if isinstance(v, dict) and "ms" in v})
    c = tt.QWEN3_8B
    g = torch.Generator(device="cuda").manual_seed(11)
    h, hk, d, pos, ps = c.num_heads, c.num_kv_heads, c.head_dim, 1056, 64
    mp = MAX_LEN // ps

    def rnd(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=g, device="cuda").to(dtype)

    lens = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    table = torch.randperm(B * mp, generator=torch.Generator().manual_seed(0)) \
        .to(torch.int32).reshape(B, mp).cuda()
    q, k, v = rnd(B, h, d), rnd(B, hk, MAX_LEN, d), rnd(B, hk, MAX_LEN, d)
    pk, pv = rnd(B * mp, hk, ps, d), rnd(B * mp, hk, ps, d)
    ik, iv, ks, vs = cs.int8_pools(torch, g, B * mp, hk, ps, d)
    # K7: the state forms
    out["K7 contiguous state"] = perf_func(lambda: A.decode_attention_state(q, k, v, lens),
                                           iters=50)[1]
    out["K7 paged state"] = perf_func(lambda: A.paged_decode_attention_state(
        q, pk, pv, table, lens), iters=50)[1]
    out["K7 int8 state"] = perf_func(lambda: A.paged_decode_attention_state(
        q, ik, iv, table, lens, k_scale=ks, v_scale=vs), iters=50)[1]
    # K2/K3 off the clustered form: f32, and D = 64 in bf16
    qf, kf, vf = q.float(), k.float(), v.float()
    out["K2 f32"] = perf_func(lambda: A.decode_attention(qf, kf, vf, pos), iters=50)[1]
    pkf, pvf = pk.float(), pv.float()
    out["K3 f32"] = perf_func(lambda: A.paged_decode_attention(qf, pkf, pvf, table, lens),
                              iters=50)[1]
    q64, k64, v64 = q[..., :64].contiguous(), k[..., :64].contiguous(), v[..., :64].contiguous()
    out["K2 D64 bf16"] = perf_func(lambda: A.decode_attention(q64, k64, v64, pos), iters=50)[1]
    pk64, pv64 = pk[..., :64].contiguous(), pv[..., :64].contiguous()
    out["K3 D64 bf16"] = perf_func(lambda: A.paged_decode_attention(q64, pk64, pv64, table, lens),
                                   iters=50)[1]
    # host time a call of the served bf16 forms
    n0 = torch.tensor(pos, dtype=torch.int32, device="cuda")
    for name, fn in (("K2 int", lambda: A.decode_attention(q, k, v, pos)),
                     ("K2 0-d", lambda: A.decode_attention(q, k, v, n0)),
                     ("K3 bf16", lambda: A.paged_decode_attention(q, pk, pv, table, lens)),
                     ("K3 int8", lambda: A.paged_decode_attention(
                         q, ik, iv, table, lens, k_scale=ks, v_scale=vs))):
        out[f"{name} host us"] = host_us(torch, fn)
    del q, k, v, pk, pv, ik, iv, qf, kf, vf, pkf, pvf
    # K16: one step over 4 layers of Qwen3-8B on a prefilled paged cache
    cfg = dataclasses.replace(c, num_layers=LAYERS)
    for n in (1, 4):
        mesh = None if n == 1 else tt.make_mesh({"tp": n})
        eng = tt.Engine.build(cfg, mesh=mesh, batch=B, max_length=MAX_LEN,
                              decode_mode="persistent", cache_layout="paged", page_size=ps,
                              generator=torch.Generator(device="cuda").manual_seed(7))
        ids = torch.randint(0, cfg.vocab, (B, PROMPT), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(300))
        eng.prefill(ids)
        tok = torch.randint(0, cfg.vocab, (B,), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(301))
        x = eng.params.embed[tok]
        sp, ca = eng.stacked(), eng.cache
        kw = dict(rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
                  qk_eps=cfg.rms_eps if cfg.qk_norm else None)
        out[f"K16 4 layers n={n}"] = perf_func(lambda: PD.persistent_decode_step(
            x, sp, ca.k, ca.v, ca.block_table, ca.seq_lens, mesh, **kw), iters=10)[1]
        del eng, sp, ca, x
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"tree": label, "rows": out}), flush=True)


def host_us(torch, fn, n: int = 100) -> float:
    """Host microseconds a call: n calls enqueued back to back after a
    synchronised warm-up (at most 3 launches a call: the queue holds them)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def step_walls(torch, eng, tok) -> dict:
    """STEPS eager decode steps on the host's clock: the wall a step (one
    synchronisation at the end) and the host's time to enqueue a step."""
    eng.decode_step(tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.decode_step(tok)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"eager_step_wall_ms": (t2 - t0) / STEPS * 1e3,
            "eager_step_host_ms": (t1 - t0) / STEPS * 1e3}


def step_profile(torch, eng, tok) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            eng.decode_step(tok)
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {}
    for e in ks:
        for key in ("decode_cluster", "decode_split", "decode_combine"):
            if key in e.name:
                names[key] = names.get(key, 0) + 1 / STEPS
    return {"device_kernel_ms": sum(e.time_range.elapsed_us() for e in ks) / 1e3 / STEPS,
            "launches": len(ks) / STEPS, "decode_attention_launches": names}


def cast_f32(torch, obj):
    """A copy of a parameter tree with every floating tensor in f32."""
    if isinstance(obj, torch.Tensor):
        return obj.float() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: cast_f32(torch, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_f32(torch, x) for x in obj)
    return obj


def decode_logits(torch, eng, cfg):
    """Prefill the seeded prompts, then STEPS steps on seeded tokens: the
    stacked (STEPS, B, V) f32 logits on the host, and the last tokens."""
    ids = torch.randint(0, cfg.vocab, (B, PROMPT), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(300))
    eng.prefill(ids)
    gen = torch.Generator(device="cuda").manual_seed(302)
    logits = []
    for _ in range(STEPS):
        tok = torch.randint(0, cfg.vocab, (B,), device="cuda", generator=gen)
        logits.append(eng.decode_step(tok).float().cpu())
    torch.cuda.synchronize()
    return torch.stack(logits), tok


def served(tree: str, label: str) -> None:
    torch, cs, tt = load(tree)
    mesh = tt.make_mesh({"tp": 4})
    cases = [("8B tp1 contiguous", tt.QWEN3_8B, None, "contiguous", None),
             ("8B tp1 paged", tt.QWEN3_8B, None, "paged", None),
             ("8B tp1 paged int8", tt.QWEN3_8B, None, "paged", "int8"),
             ("8B tp4 contiguous", tt.QWEN3_8B, mesh, "contiguous", None),
             ("8B tp4 paged", tt.QWEN3_8B, mesh, "paged", None),
             ("30B-A3B tp1 paged", tt.QWEN3_30B_A3B, None, "paged", None)]
    saved, report = {}, {}
    for name, cfg, m, layout, kv in cases:
        cfg = dataclasses.replace(cfg, num_layers=LAYERS)
        cfg = dataclasses.replace(cfg, max_length=MAX_LEN)
        eng = tt.Engine.build(cfg, mesh=m, batch=B, cache_layout=layout, page_size=64,
                              kv_dtype=kv, generator=torch.Generator(device="cuda").manual_seed(7))
        saved[name], tok = decode_logits(torch, eng, cfg)
        walls = step_walls(torch, eng, tok)
        report[name] = {**step_profile(torch, eng, tok), **walls}
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        eng32 = tt.Engine(tt.Qwen3(cfg32, mesh=m), cast_f32(torch, eng.params), batch=B,
                          cache_layout=layout, page_size=64, kv_dtype=kv)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        saved[name + " f32"] = decode_logits(torch, eng32, cfg32)[0]
        del eng32
        gc.collect()
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(saved, OUT / f"served_{label}.pt")
    print(json.dumps({"tree": label, "served": report}), flush=True)


def compare(a: str, b: str) -> None:
    import torch

    la, lb = (torch.load(OUT / f"served_{x}.pt") for x in (a, b))

    def rel(x, y):   # per step: max |x - y| over max |y|
        return [((x[i] - y[i]).abs().max() / y[i].abs().max()).item() for i in range(len(x))]

    for name in (n for n in la if not n.endswith(" f32")):
        x, y, ref = la[name], lb[name], la[name + " f32"]
        ab, a32, b32 = rel(y, x), rel(x, ref), rel(y, ref)
        print(json.dumps({"case": name, "pair": [a, b], "limit": 2.0 ** -6,
                          "b_vs_a_first_step": ab[0], "b_vs_a_worst_step": max(ab),
                          "a_vs_f32_first_step": a32[0], "a_vs_f32_worst_step": max(a32),
                          "b_vs_f32_first_step": b32[0], "b_vs_f32_worst_step": max(b32),
                          "f32_same_on_both": bool(torch.equal(ref, lb[name + " f32"])),
                          "greedy_equal_steps": int((x.argmax(-1) == y.argmax(-1)).all(-1).sum()),
                          "steps": len(x)}), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1]
    {"rows": rows, "served": served, "compare": compare}[mode](*sys.argv[2:4])
