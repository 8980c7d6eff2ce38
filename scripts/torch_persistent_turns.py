"""K16 and the kernels beside it from two checkouts on one card, in turns.

    python3 scripts/torch_persistent_turns.py rows TREE LABEL
    python3 scripts/torch_persistent_turns.py compare LABEL_A LABEL_B [LABEL_C ...]
    python3 scripts/torch_persistent_turns.py served TREE LABEL [f32] [layers=N] [seed=S]
    python3 scripts/torch_persistent_turns.py compare_served LABEL_A LABEL_B

TREE is the root of a checkout (this one, or a parent unpacked with ``git
archive`` into a directory ``.gitignore`` lists); its package is imported
from there and its kernels are built there.  Run the two in turns, parent,
change, change, parent, in one call, so that both meet the same card:

    for i in 1 2 3 4; do t=$([ $i = 1 -o $i = 4 ] && echo PARENT || echo .)
      python3 scripts/torch_persistent_turns.py rows $t run_$i; done
    python3 scripts/torch_persistent_turns.py compare run_1 run_2 run_3 run_4

``rows`` prints one JSON line, {"tree", "label", "card", "rows": {name:
ms}}, every time event-timed (CUDA events, median of 10 calls) at Qwen3-8B's
widths with seeded random weights (B = 4, position 1056 of 2048, pages of
64): K16 over 36 layers in bf16 at tp = 1 and tp = 4 (the tree's served
form), K16 over 4 layers in f32 and at head dim 64 (bf16, 64 query / 16 kv
heads) at tp = 1 and tp = 4, K4 (``tt.fused_attn_decode``, one layer, bf16)
and K15's one-shot swiglu and linear forms (``tt.fused_mlp_ar``,
``tt.fused_linear_ar``) at tp = 4.  ``compare`` prints each row of every
label and each label's ratio to the first.

``served`` builds Qwen3-8B (36 layers, or N with ``layers=N``; bf16;
weights from seed 7 + S, prompts and tokens from 300 + S and 302 + S, S = 0
unless ``seed=S``) in the "persistent" decode mode on the paged cache at tp
= 1 and tp = 4, prefills seeded 1024-token prompts (B = 4) and runs 8
decode steps on seeded tokens (the same on both sides), saving every step's
f32 logits under
build/turns_persistent/ (git-ignored); with ``f32`` also the same weights
cast to f32 (exact) served the same way (K16's f32 form, the reference
both trees are held to).  ``compare_served`` holds B's logits to A's and
each to the f32 run where B has one: the largest difference over the
largest |logit| at the first step and over all 8 (the limit of a bf16
decode is 2**-6 of it), and the steps whose greedy tokens agree.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "turns_persistent"
B, MAX_LEN, POS, PAGE = 4, 2048, 1056, 64


def rows(tree: str, label: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import triton_distributed_tpu_torch as tt
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import persistent_decode as PD

    dev = torch.device("cuda")
    out = {}

    def k16(name, c, n):
        mesh = tt.make_mesh({"tp": n}) if n > 1 else None
        gen = torch.Generator(device=dev).manual_seed(7)
        params = tt.Qwen3(c, mesh=mesh, device=None if mesh else dev).init(
            gen, scale=c.hidden ** -0.5)
        cache = tt.init_paged_cache(c.num_layers, B, c.num_kv_heads, MAX_LEN, c.head_dim,
                                    c.dtype, page_size=PAGE, device=dev, tp=n,
                                    generator=torch.Generator().manual_seed(3))
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
        cache.seq_lens.fill_(POS)
        sp = PD.stack_decode_params(params)
        x = params.embed[torch.randint(0, c.vocab, (B,), generator=gen, device=dev)]
        kw = dict(rope_theta=c.rope_theta, rms_eps=c.rms_eps, qk_eps=c.rms_eps)
        out[name] = perf_func(lambda: PD.persistent_decode_step(
            x, sp, cache.k, cache.v, cache.block_table, cache.seq_lens, mesh, **kw), iters=10)[1]
        del params, cache, sp
        torch.cuda.empty_cache()

    base = dataclasses.replace(tt.QWEN3_8B, max_length=MAX_LEN)
    for n in (1, 4):
        k16(f"K16 bf16 36 layers tp{n}", base, n)
        k16(f"K16 f32 4 layers tp{n}", dataclasses.replace(base, num_layers=4,
                                                          dtype=torch.float32), n)
        k16(f"K16 head_dim 64 4 layers tp{n}", dataclasses.replace(
            base, num_layers=4, head_dim=64, num_heads=64, num_kv_heads=16), n)
    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*s):
        return (torch.randn(*s, generator=g, device=dev) * 0.02).to(torch.bfloat16)

    c = base
    hq, hk, d = c.num_heads, c.num_kv_heads, c.head_dim
    pages = B * MAX_LEN // PAGE
    pk, pv = rnd(pages, hk, PAGE, d), rnd(pages, hk, PAGE, d)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(5)).to(
        torch.int32).view(B, -1).to(dev)
    lens = torch.full((B,), POS, dtype=torch.int32, device=dev)
    x, wqkv, qn, kn = rnd(B, c.hidden), rnd(c.hidden, (hq + 2 * hk) * d), rnd(d), rnd(d)
    out["K4 bf16 tp1"] = perf_func(lambda: tt.fused_attn_decode(
        x, wqkv, qn, kn, pk, pv, table, lens, qk_eps=1e-6), iters=10)[1]
    mesh, n = tt.make_mesh({"tp": 4}), 4
    f = c.intermediate
    gu, dn = rnd(n, c.hidden, 2 * f // n), rnd(n, f // n, c.hidden)
    h, wo = rnd(n, B, hq * d // n), rnd(n, hq * d // n, c.hidden)
    out["K15 one-shot swiglu tp4"] = perf_func(lambda: tt.fused_mlp_ar(x, gu, dn, mesh),
                                               iters=10)[1]
    out["K15 one-shot linear tp4"] = perf_func(lambda: tt.fused_linear_ar(h, wo, mesh),
                                               iters=10)[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    res = {"tree": os.path.abspath(tree), "label": label, "card": card, "rows": out}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{label}.json").write_text(json.dumps(res))
    print(json.dumps(res), flush=True)


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


def served(tree: str, label: str, *opts: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import triton_distributed_tpu_torch as tt

    f32 = "f32" in opts
    kv = dict(o.split("=") for o in opts if "=" in o)
    seed = int(kv.get("seed", 0))
    cfg = dataclasses.replace(tt.QWEN3_8B, num_layers=int(kv.get("layers", 36)))

    def steps_of(eng):
        ids = torch.randint(0, cfg.vocab, (B, 1024), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(300 + seed))
        eng.prefill(ids)
        gen = torch.Generator(device="cuda").manual_seed(302 + seed)
        steps = []
        for _ in range(8):
            tok = torch.randint(0, cfg.vocab, (B,), device="cuda", generator=gen)
            steps.append(eng.decode_step(tok).float().cpu())
        return torch.stack(steps)

    saved = {}
    for n in (1, 4):
        mesh = tt.make_mesh({"tp": n}) if n > 1 else None
        eng = tt.Engine.build(cfg, mesh=mesh, batch=B, max_length=MAX_LEN,
                              decode_mode="persistent", cache_layout="paged", page_size=PAGE,
                              generator=torch.Generator(device="cuda").manual_seed(7 + seed))
        saved[f"tp{n}"] = steps_of(eng)
        if f32:
            cfg32 = dataclasses.replace(cfg, max_length=MAX_LEN, dtype=torch.float32)
            params = cast_f32(torch, eng.params)
            del eng
            torch.cuda.empty_cache()
            kw = dict(mesh=mesh) if mesh else dict(device="cuda")
            eng = tt.Engine(tt.Qwen3(cfg32, decode_mode="persistent", **kw), params, batch=B,
                            cache_layout="paged", page_size=PAGE)
            saved[f"tp{n} f32"] = steps_of(eng)
            del params
        del eng
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(saved, OUT / f"served_{label}.pt")
    print(json.dumps({"tree": os.path.abspath(tree), "label": label, "layers": cfg.num_layers,
                      "seed": seed, "served": list(saved)}), flush=True)


def compare_served(a: str, b: str) -> None:
    import torch

    la, lb = (torch.load(OUT / f"served_{x}.pt") for x in (a, b))
    def rel(x, y):   # per step: max |x - y| over max |y|
        return [((x[i] - y[i]).abs().max() / y[i].abs().max()).item() for i in range(len(x))]

    for name in (k for k in la if not k.endswith(" f32")):
        x, y = la[name], lb[name]
        out = {"case": name, "pair": [a, b], "limit": 2.0 ** -6}
        ab = rel(y, x)
        out.update(first_step=ab[0], worst_step=max(ab),
                   greedy_equal_steps=int((x.argmax(-1) == y.argmax(-1)).all(-1).sum()))
        ref = lb.get(name + " f32")
        if ref is not None:
            a32, b32 = rel(x, ref), rel(y, ref)
            out.update(a_vs_f32_first_step=a32[0], a_vs_f32_worst_step=max(a32),
                       b_vs_f32_first_step=b32[0], b_vs_f32_worst_step=max(b32),
                       a_greedy_equal_f32=int((x.argmax(-1) == ref.argmax(-1)).all(-1).sum()),
                       b_greedy_equal_f32=int((y.argmax(-1) == ref.argmax(-1)).all(-1).sum()))
        print(json.dumps({**out, "steps": len(x)}), flush=True)


def compare(*labels: str) -> None:
    runs = [json.loads((OUT / f"{lab}.json").read_text()) for lab in labels]
    for name, first in runs[0]["rows"].items():
        print(json.dumps({"row": name, **{r["label"]: r["rows"][name] for r in runs},
                          "ratio_to_first": [r["rows"][name] / first for r in runs]}))


if __name__ == "__main__":
    {"rows": rows, "compare": compare, "served": served,
     "compare_served": compare_served}[sys.argv[1]](*sys.argv[2:])
