"""The clustered form of K2/K3 (``csrc/decode_cluster.cu``) on the CPU: its
split rule, mirrored in ``ops/attention.py``, and its merge order.

``decode_pieces`` is the device rule (each block of a (batch, kv head)'s
cluster takes an even share of the 16-row pieces of [0, len)), and
``decode_cluster_walk`` below folds those pieces as the kernel does (a warp's
pieces online, the page's K scale on the scores and its V scale on the
piece's p.v, warps merged in warp order, blocks in rank order).  The walk is
held to JAX's ``decode_attention`` and ``paged_decode_attention`` (Pallas in
interpret mode, as ``tests/test_torch_ops.py`` runs them) in f32, where the
tolerance (1e-4) is about summation order; in bf16 it is held to the port's
plain versions within one bf16 rounding of the output (2e-2: outputs are
O(1), and p is rounded at different running maxima in the two).  The kernel
itself is held to the plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from triton_distributed_tpu.ops import attention as jax_attn

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.ops import attention as A

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2
D, CAP, PS = 128, 96, 32
LENS = np.array([0, 17, 65, CAP], np.int32)   # empty, mid-piece, past a page, full
WARPS = 4    # the kernel's consumer warps, each taking every fourth piece of its block


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _merge_in_order(states):
    """(m, l, acc) states merged in the order given (the kernel's (rank,
    warp) order)."""
    mn = torch.stack([m for m, _, _ in states]).amax(dim=0)
    l, acc = 0.0, 0.0
    for m, li, ai in states:
        c = torch.exp(m - mn)
        l, acc = l + li * c, acc + ai * c[..., None]
    return mn, l, acc


def decode_cluster_walk(q, k, v, kv_len, *, sm_scale: float, soft_cap: float = 0.0,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """The clustered form's order of work, on tensors: ``k``/``v`` (B, Hkv,
    S, D), a cache or the gathered pages, int8 codes with per-position
    scales (B, Hkv, S).  Each block's pieces (``A.decode_pieces``) go to its
    WARPS consumer warps in turn; a warp folds its pieces online (the page's K scale on the scores, p rounded to q's
    type, the page's V scale on the piece's p.v), and the states of all the
    blocks' warps merge in (rank, warp) order."""
    b, h, d = q.shape
    hk, cap = k.shape[1], k.shape[2]
    g = h // hk
    lens = A._lens(kv_len, b, q.device).clamp(0, cap).tolist()
    qs = A._scaled_q(q, sm_scale).float().reshape(b, hk, g, d)
    out = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    for bi, n in enumerate(lens):
        states = []
        for pieces in A.decode_pieces(n):
            for w in range(WARPS):
                m = torch.full((hk, g), A._NEG_INF, device=q.device)
                l = torch.zeros((hk, g), device=q.device)
                acc = torch.zeros((hk, g, d), device=q.device)
                for s0, s1 in pieces[w::WARPS]:
                    s = torch.matmul(qs[bi], k[bi, :, s0:s1].float().transpose(-1, -2))
                    if k_scale is not None:
                        s = s * k_scale[bi, :, s0].float()[:, None, None]
                    if soft_cap:
                        s = torch.tanh(s / soft_cap) * soft_cap
                    mn = torch.maximum(m, s.amax(dim=-1))
                    p = torch.exp(s - mn[..., None])
                    alpha = torch.exp(m - mn)
                    pv = torch.matmul(p.to(q.dtype).float(), v[bi, :, s0:s1].float())
                    if v_scale is not None:
                        pv = pv * v_scale[bi, :, s0].float()[:, None, None]
                    l, acc, m = l * alpha + p.sum(dim=-1), acc * alpha[..., None] + pv, mn
                states.append((m, l, acc))
        _, l, acc = _merge_in_order(states)
        out[bi] = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-38)[..., None],
                              torch.zeros_like(acc))
    return out.to(q.dtype).reshape(b, h, d)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("length", [0, 1, 15, 16, 63, 64, 65, 1056, 2048])
def test_pieces_cover_the_length_once(length, cluster):
    shares = A.decode_pieces(length, cluster, page_size=64)
    assert len(shares) == cluster
    flat = [p for share in shares for p in share]
    # in rank order, back to back, from 0 to the length: each position once
    assert [s for s, _ in flat] == list(range(0, length, A.DECODE_PIECE))
    assert all(e == min(s + A.DECODE_PIECE, length) for s, e in flat)
    # even shares, and no piece straddles a page of 16 or 64 rows
    sizes = [len(share) for share in shares]
    assert max(sizes) - min(sizes) <= 1
    for ps in (16, 64):
        assert all(s // ps == (e - 1) // ps for s, e in flat)
    # more blocks than pieces: the rest have empty shares
    assert sizes.count(0) == max(0, cluster - -(-length // A.DECODE_PIECE))


def test_pieces_refuse_a_page_off_the_piece():
    with pytest.raises(ValueError, match="multiple of 16"):
        A.decode_pieces(100, 8, page_size=24)


def test_empty_shares_are_neutral():
    """An empty share's state (m = -1e30, l = 0, acc = 0) leaves any merge
    unchanged, and a sequence of length 0 gives exact zeros."""
    rng = np.random.default_rng(3)
    m, l, acc = (_t(rng.standard_normal(s).astype(np.float32)) for s in ((2, 4), (2, 4), (2, 4, 8)))
    l = l.abs() + 0.5
    empty = (torch.full((2, 4), -1e30), torch.zeros(2, 4), torch.zeros(2, 4, 8))
    for states in ([(m, l, acc), empty], [empty, (m, l, acc)], [empty, (m, l, acc), empty]):
        got = _merge_in_order(states)
        for g, w in zip(got, (m, l, acc)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    q = _t(rng.standard_normal((2, 4, D)).astype(np.float32))
    k = _t(rng.standard_normal((2, 2, CAP, D)).astype(np.float32))
    out = decode_cluster_walk(q, k, k, 0, sm_scale=D ** -0.5)
    assert not out.any()


def _case(layout: str, seed: int):
    """f32 inputs at G = 8 (16 q heads, 2 kv heads): q, the cache (or the
    pools, the table and the int8 scales) and JAX's output."""
    rng = np.random.default_rng(seed)
    b, h, hk = len(LENS), 16, 2
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    if layout == "contiguous":
        k, v = (rng.standard_normal((b, hk, CAP, D)).astype(np.float32) for _ in range(2))
        return dict(q=q, k=k, v=v)
    mp = CAP // PS
    p = b * mp
    table = rng.permutation(p).astype(np.int32).reshape(b, mp)
    table[1, 2:] = 0                        # past sequence 1's pages: page 0, never read
    if layout == "int8":
        pk, pv = (rng.integers(-127, 128, (p, hk, PS, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random((p, hk)).astype(np.float32) * 0.02 + 0.005 for _ in range(2))
        return dict(q=q, pk=pk, pv=pv, table=table, ks=ks, vs=vs)
    pk, pv = (rng.standard_normal((p, hk, PS, D)).astype(np.float32) for _ in range(2))
    return dict(q=q, pk=pk, pv=pv, table=table)


def _jax(layout: str, c: dict, cap: float) -> np.ndarray:
    j = {k: jnp.asarray(v) for k, v in c.items()}
    if layout == "contiguous":
        out = jax_attn.decode_attention(j["q"], j["k"], j["v"], jnp.asarray(LENS),
                                        soft_cap=cap)
    else:
        scales = dict(k_scale=j["ks"], v_scale=j["vs"]) if layout == "int8" else {}
        out = jax_attn.paged_decode_attention(j["q"], j["pk"], j["pv"], j["table"],
                                              jnp.asarray(LENS), soft_cap=cap, **scales)
    return np.asarray(out)


def _walk(layout: str, c: dict, cap: float, g: int, dtype=torch.float32):
    """The walk at G = g over the case's heads: each kv head repeated 8 / g
    times, so head h still attends over kv head h // 8 as in the G = 8
    case, grouped g to a kv head as the kernel groups them."""
    rep = 8 // g
    q = _t(c["q"]).to(dtype)
    if layout == "contiguous":
        k, v = (_t(c[n]).repeat_interleave(rep, dim=1).to(dtype) for n in ("k", "v"))
        ks = vs = None
    else:
        pools = [_t(c[n]).repeat_interleave(rep, dim=1) for n in ("pk", "pv")]
        if layout != "int8":
            pools = [p.to(dtype) for p in pools]
        scales = ([_t(c[n]).repeat_interleave(rep, dim=1) for n in ("ks", "vs")]
                  if layout == "int8" else [None, None])
        (k, ks), (v, vs) = (A.gather_pages(p, _t(c["table"]), s)
                            for p, s in zip(pools, scales))
    return decode_cluster_walk(q, k, v, _t(LENS), sm_scale=D ** -0.5, soft_cap=cap,
                                 k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8"])
def test_walk_matches_jax(layout, cap):
    """The pieces' states merged in split order give JAX's output, at G =
    1, 2, 4 and 8, with both soft caps, on the contiguous cache, full-
    precision pages and int8 pages (one JAX call a case at G = 8)."""
    c = _case(layout, seed=10 + len(layout) + int(cap))
    want = _jax(layout, c, cap)
    for g in (1, 2, 4, 8):
        got = _walk(layout, c, cap, g)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"G={g}")
        assert not got[0].any()              # length 0 -> exact zeros


@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8"])
def test_walk_in_bf16_within_a_rounding_of_the_plain_version(layout):
    """In the kernel's type the walk rounds p at each warp's running maximum
    and scales int8 V per piece after the product; the plain version rounds
    p at the row's maximum and scales it before: within BF16_TOL."""
    c = _case(layout, seed=20 + len(layout))
    q = _t(c["q"]).bfloat16()
    if layout == "contiguous":
        want = A.decode_attention_ref(q, _t(c["k"]).bfloat16(), _t(c["v"]).bfloat16(),
                                      _t(LENS), soft_cap=5.0)
    else:
        pools = [_t(c[n]) if layout == "int8" else _t(c[n]).bfloat16() for n in ("pk", "pv")]
        scales = dict(k_scale=_t(c["ks"]), v_scale=_t(c["vs"])) if layout == "int8" else {}
        want = A.paged_decode_attention_ref(q, *pools, _t(c["table"]), _t(LENS),
                                            soft_cap=5.0, **scales)
    for g in (1, 2, 4, 8):
        got = _walk(layout, c, 5.0, g, dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_TOL, f"G={g}: {err}"


def test_clustered_form_and_length_arguments():
    """Which calls the clustered form serves, and how a length reaches it:
    an int as an argument, a 0-d or one-element int32 tensor with stride 0
    and a (B,) one as it is, neither copied."""
    bf = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    assert A._clustered(bf, 128) and A._clustered(bf, 128, 64) and A._clustered(bf, 128, 16)
    assert not A._clustered(bf.float(), 128)
    assert not A._clustered(bf[..., :64], 64)
    assert not A._clustered(bf, 128, 24)
    assert A._length_arg(1056, 4, bf.device) == (None, 0, 1056)
    for t, stride in ((torch.tensor(7, dtype=torch.int32), 0),
                      (torch.tensor([7], dtype=torch.int32), 0),
                      (torch.arange(4, dtype=torch.int32), 1)):
        got, s, _ = A._length_arg(t, 4, bf.device)
        assert got.data_ptr() == t.data_ptr() and s == stride
    got, s, _ = A._length_arg(torch.arange(8, dtype=torch.int32)[::2], 4, bf.device)
    assert s == 2
    with pytest.raises(ValueError):
        A._length_arg(torch.zeros(3, dtype=torch.int32), 4, bf.device)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_step_makes_its_lengths_once(layout, monkeypatch):
    """Qwen3's per-kernel decode computes the lengths after the append once a
    step: every layer's attention call receives the same tensor."""
    from triton_distributed_tpu_torch.models import qwen

    cfg = tt.ModelConfig(num_layers=3, hidden=32, intermediate=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, vocab=64, max_length=64,
                         dtype=torch.float32)
    eng = tt.Engine.build(cfg, device="cpu", batch=2, cache_layout=layout, page_size=16)
    seen = []
    name = "paged_decode_attention" if layout == "paged" else "decode_attention"
    real = getattr(qwen, name)

    def recording(*args, **kw):
        seen.append(args[4] if layout == "paged" else args[3])
        return real(*args, **kw)

    monkeypatch.setattr(qwen, name, recording)
    logits = eng.prefill(torch.randint(0, 64, (2, 5), generator=torch.Generator().manual_seed(1)))
    eng.decode_step(logits.argmax(-1).to(torch.int32))
    assert len(seen) == cfg.num_layers
    assert all(s is seen[0] for s in seen)
    assert seen[0].reshape(-1).tolist() == [6] * (2 if layout == "paged" else 1)
