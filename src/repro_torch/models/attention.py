"""Attention: GQA + RoPE + sliding window.  Port of
``repro.models.attention`` for the ``attn`` and ``local`` kinds (global and
sliding-window causal attention; softcap, QK-norm and MLA come with the
families that use them).

Two execution paths:

* :func:`flash_attention` - prefill and calibration, plain torch as in
  the reference, which leaves it to XLA.  The reference's
  chunked online-softmax forward (query blocks in a Python loop,
  triangle-exact under the causal mask; kv blocks with a running
  (m, l, acc) state), f32 logits and accumulator, probabilities rounded to
  the value dtype before PV.  Under autograd its backward is the
  reference's ``custom_vjp`` (:class:`_Flash`): it recomputes
  p = exp(s + bias - L) in f32 from the saved logsumexp, where autograd
  through the forward would differentiate the bf16-rounded p.
* :func:`decode_attend`   - one query per row against the KV ring, with
  per-row positions; a windowed layer's ring holds min(capacity, window)
  slots.  ``kv_shards`` picks how:

  - ``None`` (default): the reference's replicated ``decode_attend``,
    plain torch, which rounds ``p / l`` to the cache dtype (bf16) before
    PV;
  - ``1``: the ``flash_decode`` kernel (``ops.py:76 decode_attention``),
    f32 probabilities;
  - ``S >= 2``: the reference's tensor-parallel branch on a mesh with
    ``model = S`` (``kernels/shard.py decode_attend_sharded``): the
    ``flash_decode_partial`` kernel over S capacity shards, then the
    combine kernel.

bf16 einsums in torch return bf16, where JAX's
``preferred_element_type=float32`` returns f32, so operands are upcast to
f32 wherever the reference keeps an f32 result.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import shard as ksh
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import common as cm
from repro_torch.models.common import Builder

PyTree = Any
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Flash attention (forward; backward under autograd)
# ---------------------------------------------------------------------------

def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, *,
               window: int = 0) -> torch.Tensor:
    """Additive causal (and sliding-window) mask bias, 0 or NEG_INF.
    qpos: (Sq,), kpos: (Sk,)."""
    ok = kpos[None, :] <= qpos[:, None]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def _qk(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    # q: (B, Sq, K, G, D)  k: (B, Sk, K, D) -> (B, K, G, Sq, Sk) fp32
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _flash_fwd_block(q_blk, k, v, *, qpos, scale, kv_block, window):
    """One query block vs all (needed) kv blocks -> (normalized f32 output,
    m, l)."""
    B, Sq, K, G, _ = q_blk.shape
    Dv = v.shape[-1]
    dev = q_blk.device
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, K, G, Dv), dtype=torch.float32, device=dev)
    for ikv in range(k.shape[1] // kv_block):
        sl = slice(ikv * kv_block, (ikv + 1) * kv_block)
        kpos = ikv * kv_block + torch.arange(kv_block, device=dev)
        s = _qk(q_blk, k[:, sl], scale)
        s = s + _mask_bias(qpos, kpos, window=window)[None, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                          v[:, sl].float())
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return o, m, l


def _q_blocks(Sq, Sk, q_block, kv_block, device):
    """(query slice, qpos, visible kv length n) per query block: only kv
    blocks whose start can be visible (static causal bound)."""
    for iq in range(Sq // q_block):
        qpos = (Sk - Sq) + iq * q_block + torch.arange(q_block, device=device)
        hi = min(Sk, (Sk - Sq) + (iq + 1) * q_block)
        yield (slice(iq * q_block, (iq + 1) * q_block), qpos,
               -(-hi // kv_block) * kv_block)


def _flash_fwd(q, k, v, window, scale, q_block, kv_block):
    """Grouped q (B,Sq,K,G,D) -> (out in q.dtype, logsumexp L (B,K,G,Sq))."""
    os_, Ls = [], []
    for sl, qpos, n in _q_blocks(q.shape[1], k.shape[1], q_block, kv_block,
                                 q.device):
        o, m, l = _flash_fwd_block(q[:, sl], k[:, :n], v[:, :n], qpos=qpos,
                                   scale=scale, kv_block=kv_block,
                                   window=window)
        os_.append(o)
        Ls.append(m + torch.log(torch.clamp_min(l, 1e-30)))
    return torch.cat(os_, dim=1).to(q.dtype), torch.cat(Ls, dim=3)


def _flash_bwd_block(q_blk, k, v, o_blk, L_blk, do_blk, *, qpos, scale,
                     kv_block, window):
    """Backward for one query block: (dq_blk, dk, dv), f32, dk/dv over the
    block's visible kv length."""
    B, Sq, K, G, D = q_blk.shape
    Sk = k.shape[1]
    dev = q_blk.device
    do_f = do_blk.float()
    Drow = (do_f * o_blk.float()).sum(dim=-1).permute(0, 2, 3, 1)
    dq = torch.zeros((B, Sq, K, G, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, K, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, K, v.shape[-1]), dtype=torch.float32, device=dev)
    for ikv in range(Sk // kv_block):
        sl = slice(ikv * kv_block, (ikv + 1) * kv_block)
        kpos = ikv * kv_block + torch.arange(kv_block, device=dev)
        ks, vs = k[:, sl].float(), v[:, sl].float()
        s = _qk(q_blk, k[:, sl], scale)
        bias = _mask_bias(qpos, kpos, window=window)[None, None, None]
        p = torch.exp(s + bias - L_blk[..., None])          # (B,K,G,Sq,Sk)
        dp = torch.einsum("bqkgd,bskd->bkgqs", do_f, vs)
        dv[:, sl] += torch.einsum("bkgqs,bqkgd->bskd", p, do_f)
        ds = p * (dp - Drow[..., None]) * scale
        dq += torch.einsum("bkgqs,bskd->bqkgd", ds, ks)
        dk[:, sl] += torch.einsum("bkgqs,bqkgd->bskd", ds, q_blk.float())
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` ``_flash``: forward saves
    (q, k, v, out, L); backward recomputes the probabilities in f32 per
    query block and kv block (nothing quadratic is saved)."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale, q_block, kv_block):
        out, L = _flash_fwd(q, k, v, window, scale, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.cfg = (window, scale, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, L = ctx.saved_tensors
        window, scale, q_block, kv_block = ctx.cfg
        dqs = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for sl, qpos, n in _q_blocks(q.shape[1], k.shape[1], q_block,
                                     kv_block, q.device):
            dq_blk, dk_p, dv_p = _flash_bwd_block(
                q[:, sl], k[:, :n], v[:, :n], out[:, sl], L[..., sl],
                do[:, sl], qpos=qpos, scale=scale, kv_block=kv_block,
                window=window)
            dqs.append(dq_blk)
            dk[:, :n] += dk_p
            dv[:, :n] += dv_p
        return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def flash_attention(q, k, v, *, window=0, scale=None, q_block=None,
                    kv_block=None):
    """Causal attention, over the last ``window`` positions when window > 0.
    q: (B,Sq,H,D) or (B,Sq,K,G,D); k,v: (B,Sk,K,D).  Returns (B,Sq,H,Dv)
    (or grouped) in q.dtype."""
    squeeze = q.dim() == 4
    if squeeze:
        B, Sq, H, D = q.shape
        q = q.reshape(B, Sq, k.shape[2], H // k.shape[2], D)
    B, Sq, K, G, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    q_block = q_block or min(512, Sq)
    kv_block = kv_block or min(512, Sk)
    if Sq % q_block or Sk % kv_block:
        raise ValueError((Sq, q_block, Sk, kv_block))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _Flash.apply(q, k, v, window, scale, q_block, kv_block)
    else:
        out = torch.cat([
            _flash_fwd_block(q[:, sl], k[:, :n], v[:, :n], qpos=qpos,
                             scale=scale, kv_block=kv_block,
                             window=window)[0]
            for sl, qpos, n in _q_blocks(Sq, Sk, q_block, kv_block,
                                         q.device)], dim=1).to(q.dtype)
    return out.reshape(B, Sq, K * G, v.shape[-1]) if squeeze else out


# ---------------------------------------------------------------------------
# Standard attention module (init/apply)
# ---------------------------------------------------------------------------

def attn_init(b: Builder, *, d_model: int, num_heads: int, num_kv: int,
              head_dim: int) -> PyTree:
    h, kv = num_heads * head_dim, num_kv * head_dim
    return {
        "wq": cm.dense_init(b, d_model, h, ("embed", "qkv")),
        "wk": cm.dense_init(b, d_model, kv, ("embed", "qkv")),
        "wv": cm.dense_init(b, d_model, kv, ("embed", "qkv")),
        "wo": cm.dense_init(b, h, d_model, ("qkv", "embed")),
    }


def make_kv_cache(batch: int, capacity: int, num_kv: int, head_dim: int, *,
                  device, lead: tuple = (),
                  dtype: torch.dtype = torch.bfloat16) -> PyTree:
    shape = (*lead, batch, capacity, num_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_apply_full(p: PyTree, x: torch.Tensor, *, positions: torch.Tensor,
                    num_heads: int, num_kv: int, head_dim: int,
                    rope_theta: float = 1e4, use_rope: bool = True,
                    window: int = 0, scale: float | None = None,
                    cache_capacity: int = 0,
                    ) -> tuple[torch.Tensor, PyTree | None]:
    """Prefill path. Returns (y, kv_cache or None); a windowed layer's
    cache ring holds min(cache_capacity, window) slots."""
    B, S, _ = x.shape
    q = cm.dense(p["wq"], x).reshape(B, S, num_heads, head_dim)
    k = cm.dense(p["wk"], x).reshape(B, S, num_kv, head_dim)
    v = cm.dense(p["wv"], x).reshape(B, S, num_kv, head_dim)
    if use_rope:
        q = cm.rope(q, positions, theta=rope_theta)
        k = cm.rope(k, positions, theta=rope_theta)
    o = flash_attention(q, k, v, window=window, scale=scale)
    y = cm.dense(p["wo"], o.reshape(B, S, num_heads * head_dim))
    cache = None
    if cache_capacity:
        C = min(cache_capacity, window) if window else cache_capacity
        cache = {"k": _ring_store(k, C), "v": _ring_store(v, C)}
    return y, cache


def _ring_store(x: torch.Tensor, capacity: int) -> torch.Tensor:
    """Store the last min(S, C) tokens of x (B, S, ...) into ring slots
    p % C."""
    B, S = x.shape[:2]
    n = min(S, capacity)
    pos = torch.arange(S - n, S, device=x.device)
    buf = torch.zeros((B, capacity) + tuple(x.shape[2:]),
                      dtype=torch.bfloat16, device=x.device)
    buf[:, pos % capacity] = x[:, S - n:].to(torch.bfloat16)
    return buf


def ring_slot(t: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.remainder(t, capacity)


def ring_positions(t: torch.Tensor, capacity: int) -> torch.Tensor:
    """Position stored in each ring slot after writing token t at t % C.

    Slot j holds the latest position p <= t with p % C == j, or is empty,
    encoded as a position past t that never passes the mask.  t: scalar
    (-> (C,)) or per-row (B,) (-> (B, C)).  ``torch.remainder`` keeps the
    floor-modulo sign of ``jnp.mod`` on negative operands.
    """
    j = torch.arange(capacity, device=t.device)
    tt = t.to(torch.int32)[..., None]
    p = tt - torch.remainder(tt - j, capacity)
    return torch.where(p >= 0, p, tt + 1 + capacity)


def decode_attend(q, cache_k, cache_v, kpos, t, *, scale=None, window=0,
                  kv_shards=None):
    """One-token attention against a cache.

    q: (B, H, D); cache_k/v: (B, C, K, D); kpos: position of each slot,
    (C,) or (B, C); t: current position, scalar or (B,).  Valid slots:
    kpos <= t, and t - kpos < window when window > 0.  ``kv_shards``: None
    (replicated, plain torch), 1 (``flash_decode``) or S >= 2 dividing C
    (S capacity shards, ``flash_decode_partial`` + combine); see the
    module docstring.
    """
    B, H, D = q.shape
    K = cache_k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, K, H // K, D)
    kb = kpos if kpos.dim() == 2 else kpos[None]             # (1|B, C)
    tq = t.to(torch.int32)
    tb = tq[:, None] if tq.dim() == 1 else tq                # (B, 1) | ()
    ok = kb <= tb
    if window:
        ok &= tb - kb < window
    if kv_shards is not None:
        ksh.check_kv_shards(kv_shards, (cache_k.shape[1],))
        ok = ok.expand(B, cache_k.shape[1])
        if kv_shards == 1:
            bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
            o = flash_decode(qg, cache_k, cache_v, bias, scale=scale)
        else:
            o = ksh.decode_attend_sharded(qg, cache_k, cache_v, ok,
                                          shards=kv_shards, scale=scale)
        return o.reshape(B, H, cache_v.shape[-1]).to(q.dtype)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), cache_k.float()) * scale
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgc,bckd->bkgd", (p / l).to(cache_v.dtype).float(),
                     cache_v.float())
    return o.reshape(B, H, D).to(q.dtype)


def attn_apply_decode(p: PyTree, x: torch.Tensor, cache: PyTree,
                      t: torch.Tensor, *, num_heads: int, num_kv: int,
                      head_dim: int, rope_theta: float = 1e4,
                      use_rope: bool = True, window: int = 0,
                      scale: float | None = None, kv_shards: int | None = None,
                      ) -> tuple[torch.Tensor, PyTree]:
    """Decode one token per row.  x: (B, 1, d); t: (B,) per-row positions.

    Row b writes its own ring slot t[b] % C of ``cache`` IN PLACE (the
    reference returns an updated copy; the values are the same) and
    attends at its own position, through :func:`decode_attend`'s
    ``kv_shards`` path.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    C = cache["k"].shape[1]
    q = cm.dense(p["wq"], x).reshape(B, 1, num_heads, head_dim)
    k = cm.dense(p["wk"], x).reshape(B, 1, num_kv, head_dim)
    v = cm.dense(p["wv"], x).reshape(B, 1, num_kv, head_dim)
    if use_rope:
        q = cm.rope(q, t[:, None], theta=rope_theta)
        k = cm.rope(k, t[:, None], theta=rope_theta)
    rows = torch.arange(B, device=x.device)
    slot = ring_slot(t, C).long()
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    kpos = ring_positions(t, C)
    o = decode_attend(q[:, 0], cache["k"], cache["v"], kpos, t, scale=scale,
                      window=window, kv_shards=kv_shards)
    y = cm.dense(p["wo"], o.reshape(B, 1, num_heads * head_dim))
    return y, cache


def attn_apply_verify(p: PyTree, x: torch.Tensor, cache: PyTree,
                      t: torch.Tensor, *, num_heads: int, num_kv: int,
                      head_dim: int, rope_theta: float = 1e4,
                      use_rope: bool = True, scale: float | None = None,
                      ) -> tuple[torch.Tensor, PyTree]:
    """Teacher-forced S-token decode in one pass (speculative verify).

    x: (B, S, d), S fed tokens per row; t: (B,) per-row start positions,
    so row b's token i sits at position t[b] + i.  All S ring rows are
    written first (in place), then every query attends over the whole ring
    with the per-query mask kpos <= t + i, so in-chunk causality falls out
    of the position mask that sequential decode uses.  Plain torch, as the
    reference's ``jnp.einsum`` pass: f32 scores, probabilities ``p / l``
    rounded to the cache dtype before PV.  The caller guarantees
    max(t) + S <= capacity (no ring wrap); windowed rings are excluded.
    """
    B, S, _ = x.shape
    C = cache["k"].shape[1]
    q = cm.dense(p["wq"], x).reshape(B, S, num_heads, head_dim)
    k = cm.dense(p["wk"], x).reshape(B, S, num_kv, head_dim)
    v = cm.dense(p["wv"], x).reshape(B, S, num_kv, head_dim)
    pos = t.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=x.device)                  # (B, S)
    if use_rope:
        q = cm.rope(q, pos, theta=rope_theta)
        k = cm.rope(k, pos, theta=rope_theta)
    rows = torch.arange(B, device=x.device)[:, None]
    slot = ring_slot(pos, C).long()
    cache["k"][rows, slot] = k.to(cache["k"].dtype)
    cache["v"][rows, slot] = v.to(cache["v"].dtype)
    K, G = num_kv, num_heads // num_kv
    scale = head_dim ** -0.5 if scale is None else scale
    qg = q.reshape(B, S, K, G, head_dim)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.float(),
                     cache["k"].float()) * scale
    kpos = ring_positions(pos[:, -1], C)                         # (B, C)
    ok = kpos[:, None, :] <= pos[:, :, None]                     # (B, S, C)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    l = pr.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqc,bckd->bqkgd",
                     (pr / l).to(cache["v"].dtype).float(),
                     cache["v"].float())
    o = o.reshape(B, S, num_heads * head_dim).to(x.dtype)
    return cm.dense(p["wo"], o), cache
