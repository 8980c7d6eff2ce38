"""Two checkouts on one card, in turns: K6 (the tiled GEMM) and K8 (the
chunk fold), and the kernels that share their code.

    python3 scripts/torch_local_turns.py rows TREE LABEL     # one checkout's rows
    python3 scripts/torch_local_turns.py compare LABEL_A LABEL_B

TREE is the root of a checkout (this one, or a parent unpacked with ``git
archive`` into a directory ``.gitignore`` lists); its package and its
``chip_smoke.py`` are imported from there, and its kernels are built there.
Run the two in turns, parent, change, change, parent, in one call, so that
both meet the same card, clocks and neighbours:

    for t in PARENT . . PARENT; do
      python3 scripts/torch_local_turns.py rows $t LABEL_i
    done
    python3 scripts/torch_local_turns.py compare parent_1 change_2

``rows`` times with CUDA events (``perf_func``, median of the calls) and
prints one JSON line, {"tree", "label", "card", "rows": {name: ms}}, also
written to build/turns_local/LABEL.json:

- K6 at each of ``chip_smoke.py``'s MATMUL_MAIN shapes (bf16, seeded
  operands): every tile the tree builds, its default tile, the fastest, and
  ``torch.matmul``;
- K8 folding four 1024-key chunks into q (1, 32, 1024, 128) bf16 at
  q_offset 3072 (the last rank of a 4-way ring): each chunk and the whole
  fold, SDPA over each (q, chunk); the fold's f32 and D = 64 forms (one
  full chunk each);
- K1 at the Qwen3-8B prefill shape (bf16, B = 4, 1024 tokens), the wgmma
  loop alone (``comm/launch.py::loop_product``) at the qkv product, and K19
  fused at 4096^3: code K6 and K8 share, which must not move.

``compare`` prints, for every row both runs have, B's time over A's.
"""
import json
import os
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "turns_local"


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
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.comm.launch import loop_product
    from triton_distributed_tpu_torch.core import build
    from triton_distributed_tpu_torch.core.utils import perf_func
    from triton_distributed_tpu_torch.ops import attention as A
    from triton_distributed_tpu_torch.ops import matmul as M
    from triton_distributed_tpu_torch.tools import overlap as OV

    build.library()
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
    out = {}
    for name, m, k, n in cs.MATMUL_MAIN:
        a, b = cs.k6_operands(torch, gen, m, k, n, bf)
        tiles = {}
        for tile in M.KERNEL_TILES[bf]:
            tiles[tile] = perf_func(lambda: M.matmul(a, b, config=tile), iters=10)[1]
            out[f"matmul[{name}] {tile}"] = tiles[tile]
        out[f"matmul[{name}] default"] = tiles[M.DEFAULT_TILES[bf]]
        out[f"matmul[{name}] best"] = min(tiles.values())
        out[f"torch.matmul[{name}]"] = perf_func(lambda: torch.matmul(a, b), iters=10)[1]
        del a, b
        torch.cuda.empty_cache()

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    sq, h, hk, d = cs.RING_CHUNK, 32, 8, 128
    q = rnd(1, h, sq, d)
    q_off = torch.tensor((cs.RING - 1) * sq, dtype=torch.int32, device="cuda")
    state = A.init_attention_state(1, h, sq, d)
    total = sdpa = 0.0
    for j in range(cs.RING):
        kc, vc = rnd(1, hk, sq, d), rnd(1, hk, sq, d)
        st = state
        ms = perf_func(lambda: A.flash_attention_chunk(q, kc, vc, st, q_off, j * sq))[1]
        lib = perf_func(lambda: F.scaled_dot_product_attention(
            q, kc, vc, is_causal=j == cs.RING - 1, enable_gqa=True))[1]
        out[f"flash_attention_chunk[chunk {j}]"] = ms
        out[f"sdpa[chunk {j}]"] = lib
        total, sdpa = total + ms, sdpa + lib
        state = A.flash_attention_chunk(q, kc, vc, st, q_off, j * sq)
    out["flash_attention_chunk[fold]"], out["sdpa[fold]"] = total, sdpa
    for form, dt, dd in (("f32", torch.float32, 128), ("D = 64", bf, 64)):
        qf, kf, vf = rnd(1, h, sq, dd, dtype=dt), rnd(1, hk, sq, dd, dtype=dt), \
            rnd(1, hk, sq, dd, dtype=dt)
        sf = A.init_attention_state(1, h, sq, dd)
        out[f"flash_attention_chunk[{form}, a full chunk]"] = perf_func(
            lambda: A.flash_attention_chunk(qf, kf, vf, sf, q_off, 0), iters=10)[1]
    del q, state, qf, kf, vf, sf

    qp, kp, vp = rnd(4, 32, 1024, 128), rnd(4, 8, 1024, 128), rnd(4, 8, 1024, 128)
    out["flash_attention[Qwen3-8B prefill]"] = perf_func(
        lambda: A.flash_attention(qp, kp, vp, causal=True))[1]
    del qp, kp, vp
    x, w = cs.k6_operands(torch, gen, 4096, 4096, 6144, bf)
    x, w = x.unsqueeze(0), w.unsqueeze(0)
    out["wgmma_loop[Qwen3-8B qkv]"] = perf_func(lambda: loop_product(x, w), iters=10)[1]
    a, b = cs.k6_operands(torch, gen, 4096, 4096, 4096, bf)
    fused = dict(zip(OV.MODES, OV.overlap_kernels(4096, 4096, 4096, dtype=bf)))["fused"]
    out["overlap_probe[fused 4096^3]"] = perf_func(lambda: fused(a, b), iters=10)[1]

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
