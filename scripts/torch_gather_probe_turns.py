"""Two checkouts on one card, in turns: K9 (the AllGather) in every form, B17's
parity-slot layer on it, K19 (the overlap probe) in every mode and tile, and
the kernels that share their code.

    python3 scripts/torch_gather_probe_turns.py rows TREE LABEL   # one checkout's rows
    python3 scripts/torch_gather_probe_turns.py compare LABEL_A LABEL_B

TREE is the root of a checkout (this one, or a parent unpacked with ``git
archive`` into a directory ``.gitignore`` lists); its package and its
``chip_smoke.py`` are imported from there, and its kernels are built there.
Run the two in turns, parent, change, change, parent, in one call, so that
both meet the same card, clocks and neighbours:

    for t in PARENT . . PARENT; do
      python3 scripts/torch_gather_probe_turns.py rows $t LABEL_i
    done
    python3 scripts/torch_gather_probe_turns.py compare parent_1 change_2

``rows`` times with CUDA events (``perf_func``, median of the calls) and
prints one JSON line, {"tree", "label", "card", "rows": {name: ms}}, also
written to build/turns_gather_probe/LABEL.json.  At Qwen3-8B's width under
tp = 4 on co-located ranks, bf16 (``chip_smoke.py``'s main shapes):

- K9's push, ring and two-way ring on shards of 1 and 1024 rows of 4096 (the
  public entry's form, and the system-scope form where the tree has one),
  and B17's layer (two-way ring, 1024 rows);
- K10 on 4096 x 4096 partials; K11's one-shot (4 x 4096) and two-shot
  (4096 x 4096);
- K12 (qkv, gate_up) and K13 (o, down) at the prefill, K14's one-shot and
  ring (o, down) and K15's one-shot (swiglu, o) at the decode;
- K5's prefill form (32768 rows over 128 experts, Qwen3-30B-A3B's up and
  down), K6 at its default tile and the wgmma loop alone
  (``comm/launch.py::loop_product``) at the qkv product and 4096^3;
- K19's fused, dma and mxu modes at 4096^3 on every built bf16 tile, and
  ``torch.matmul`` at 4096^3.

``compare`` prints, for every row both runs have, B's time over A's.
"""
import inspect
import json
import os
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "turns_gather_probe"


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
    from triton_distributed_tpu_torch import comm
    from triton_distributed_tpu_torch.comm.allgather import _all_gather
    from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod
    from triton_distributed_tpu_torch.comm.launch import loop_product
    from triton_distributed_tpu_torch.core import build
    from triton_distributed_tpu_torch.core.mesh import make_mesh
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import fused_decode as FD
    from triton_distributed_tpu_torch.ops import group_gemm as G
    from triton_distributed_tpu_torch.ops import matmul as M
    from triton_distributed_tpu_torch.ops.gemm_ar import _gemm_ar
    from triton_distributed_tpu_torch.tools import overlap as OV

    build.library()
    bf, n, w = torch.bfloat16, cs.COLL_TP, cs.COLL_WIDTH
    mesh = make_mesh({"tp": n})
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 171)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    def ms(fn, iters=20):
        return perf_func(fn, iters=iters)[1]

    out = {}
    scoped = "system_scope" in inspect.signature(_all_gather).parameters
    for rows_ in (1, cs.BATCH * cs.PROMPT // n):
        x = rnd(n, rows_, w)
        for m in list(comm.AllGatherMethod)[1:]:
            key = f"all_gather[{m.value} {rows_}x{w}]"
            out[key] = ms(lambda: _all_gather(x, mesh, "tp", m, -1))
            if scoped:
                out[f"{key} system scope"] = ms(
                    lambda: _all_gather(x, mesh, "tp", m, -1, system_scope=True))
    layer = tt.AllGatherLayer(mesh, cs.BATCH * cs.PROMPT // n, (w,), dtype=bf,
                              method=comm.AllGatherMethod.RING_BIDIR)
    x = rnd(n, cs.BATCH * cs.PROMPT // n, w)
    out[f"allgather_layer[ring_bidir {x.shape[1]}x{w}]"] = ms(lambda: layer(x))
    xr = rnd(n, cs.BATCH * cs.PROMPT, w)
    out[f"reduce_scatter[ring {xr.shape[1]}x{w}]"] = ms(lambda: comm.reduce_scatter(xr, mesh))
    x1 = rnd(n, cs.BATCH, w)
    for m, inp in ((AllReduceMethod.ONE_SHOT, x1), (AllReduceMethod.TWO_SHOT, xr)):
        out[f"all_reduce[{m.value} {inp.shape[1]}x{w}]"] = ms(
            lambda: comm.all_reduce(inp, mesh, method=m, out_dtype=bf))
    del x, xr, x1, layer

    for name, kind, m, k, cols, _ in cs.OVERLAP_MAIN:
        if kind == "ag_gemm":
            a, b = rnd(n, m // n, k), rnd(n, k, cols // n, scale=k ** -0.5)
            out[name] = ms(lambda: tt.ag_gemm(a, b, mesh), 10)
        elif kind == "gemm_rs":
            a, b = rnd(n, m, k // n), rnd(n, k // n, cols, scale=k ** -0.5)
            out[name] = ms(lambda: tt.gemm_rs(a, b, mesh), 10)
        else:
            a, b = rnd(n, m, k // n), rnd(n, k // n, cols, scale=k ** -0.5)
            for meth in (AllReduceMethod.ONE_SHOT, AllReduceMethod.TWO_SHOT):
                out[f"{name} {meth.value}"] = ms(lambda: _gemm_ar(a, b, mesh, "tp", bf, meth))
        del a, b
    c = tt.QWEN3_8B
    k, f = c.hidden, c.intermediate // n
    x, gu, dn = rnd(cs.BATCH, k), rnd(n, k, 2 * f, scale=k ** -0.5), rnd(n, f, k, scale=f ** -0.5)
    h, wo = rnd(n, cs.BATCH, k // n), rnd(n, k // n, k, scale=k ** -0.5)
    out["fused_mlp_ar[swiglu]"] = ms(lambda: FD.fused_mlp_ar(x, gu, dn, mesh))
    out["fused_linear_ar[o]"] = ms(lambda: FD.fused_linear_ar(h, wo, mesh))
    del x, gu, dn, h, wo

    moe = tt.QWEN3_30B_A3B
    t, e = cs.MOE_TOKENS * moe.top_k, moe.num_experts
    ids = torch.randint(0, e, (t,), device="cuda", generator=gen)
    splits = torch.bincount(ids, minlength=e).to(torch.int32)
    for name, kk, nn in (("up", moe.hidden, 2 * moe.moe_intermediate),
                         ("down", moe.moe_intermediate, moe.hidden)):
        xs, we = rnd(t, kk), rnd(e, kk, nn, scale=kk ** -0.5)
        out[f"grouped_matmul[prefill {name}]"] = ms(lambda: G.grouped_matmul(xs, we, splits), 10)
        del xs, we

    for name, m, k, nn in (("qkv", 4096, 4096, 6144), ("4096^3", 4096, 4096, 4096)):
        a, b = cs.k6_operands(torch, gen, m, k, nn, bf)
        out[f"matmul[{name}] default"] = ms(
            lambda: M.matmul(a, b, config=M.DEFAULT_TILES[bf]), 10)
        out[f"wgmma_loop[{name}]"] = ms(lambda: loop_product(a[None], b[None]), 10)
        out[f"torch.matmul[{name}]"] = ms(lambda: torch.matmul(a, b), 10)
    # a, b: the 4096^3 operands of the last row above
    for tile in OV.BUILT_TILES[bf]:
        fns = OV.overlap_kernels(4096, 4096, 4096, bm=tile[0], bn=tile[1], bk=tile[2], dtype=bf)
        for mode, fn in zip(OV.MODES, fns):
            out[f"overlap_probe[{mode} {tile[0]}x{tile[1]}x{tile[2]}]"] = ms(
                lambda: fn(a, b), 10)
    dflt = "x".join(map(str, OV.DEFAULT_TILES[bf]))
    out["hidden_pct (default tile)"] = OV.hidden_pct(
        *(out[f"overlap_probe[{mode} {dflt}]"] for mode in OV.MODES))

    line = {"tree": tree, "label": label, "card": tt.card_identity(), "rows": out}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{label}.json").write_text(json.dumps(line))
    print(json.dumps(line), flush=True)


def compare(a: str, b: str) -> None:
    ra, rb = (json.loads((OUT / f"{x}.json").read_text())["rows"] for x in (a, b))
    print(json.dumps({"compare": [a, b], "rows": {
        k: {a: ra[k], b: rb[k], "ratio": rb[k] / ra[k]} for k in ra if k in rb}}), flush=True)


if __name__ == "__main__":
    cmd = sys.argv[1:2]
    if cmd == ["rows"] and len(sys.argv) == 4:
        rows(sys.argv[2], sys.argv[3])
    elif cmd == ["compare"] and len(sys.argv) == 4:
        compare(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
