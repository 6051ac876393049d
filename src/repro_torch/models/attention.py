"""Attention: GQA + RoPE.  Port of ``repro.models.attention`` for the
``attn`` kind (global causal attention; windows, softcap, QK-norm and MLA
come with the families that use them).

Two execution paths, both plain torch as in the reference, which leaves
them to XLA:

* :func:`flash_attention` - prefill.  The reference's chunked online-softmax
  forward (query blocks in a Python loop, triangle-exact under the causal
  mask; kv blocks with a running (m, l, acc) state), f32 logits and
  accumulator, probabilities rounded to the value dtype before PV.
* :func:`decode_attend`   - one query per row against the KV ring, with
  per-row positions.  It rounds ``p / l`` to the cache dtype (bf16) before
  PV, as the reference's ``decode_attend`` does (the TPU ``flash_decode``
  kernel keeps f32 probabilities; serving does not call it).

bf16 einsums in torch return bf16, where JAX's
``preferred_element_type=float32`` returns f32, so operands are upcast to
f32 wherever the reference keeps an f32 result.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import common as cm
from repro_torch.models.common import Builder

PyTree = Any
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Flash attention (forward only)
# ---------------------------------------------------------------------------

def _causal_bias(qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
    """Additive causal mask bias (0 or NEG_INF). qpos: (Sq,), kpos: (Sk,)."""
    return torch.where(kpos[None, :] <= qpos[:, None], 0.0, NEG_INF)


def _qk(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    # q: (B, Sq, K, G, D)  k: (B, Sk, K, D) -> (B, K, G, Sq, Sk) fp32
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _flash_fwd_block(q_blk, k, v, *, qpos, scale, kv_block):
    """One query block vs all (needed) kv blocks -> normalized f32 output."""
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
        s = s + _causal_bias(qpos, kpos)[None, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                          v[:, sl].float())
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    return acc / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]


def flash_attention(q, k, v, *, scale=None, q_block=None, kv_block=None):
    """Causal attention.  q: (B,Sq,H,D) or (B,Sq,K,G,D); k,v: (B,Sk,K,D).
    Returns (B,Sq,H,Dv) (or grouped) in q.dtype."""
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
    outs = []
    for iq in range(Sq // q_block):
        qpos = (Sk - Sq) + iq * q_block + torch.arange(q_block,
                                                       device=q.device)
        # only kv blocks whose start can be visible (static causal bound)
        hi = min(Sk, (Sk - Sq) + (iq + 1) * q_block)
        n = -(-hi // kv_block) * kv_block
        outs.append(_flash_fwd_block(
            q[:, iq * q_block:(iq + 1) * q_block], k[:, :n], v[:, :n],
            qpos=qpos, scale=scale, kv_block=kv_block))
    out = torch.cat(outs, dim=1).to(q.dtype)
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
                    scale: float | None = None, cache_capacity: int = 0,
                    ) -> tuple[torch.Tensor, PyTree | None]:
    """Prefill path. Returns (y, kv_cache or None)."""
    B, S, _ = x.shape
    q = cm.dense(p["wq"], x).reshape(B, S, num_heads, head_dim)
    k = cm.dense(p["wk"], x).reshape(B, S, num_kv, head_dim)
    v = cm.dense(p["wv"], x).reshape(B, S, num_kv, head_dim)
    if use_rope:
        q = cm.rope(q, positions, theta=rope_theta)
        k = cm.rope(k, positions, theta=rope_theta)
    o = flash_attention(q, k, v, scale=scale)
    y = cm.dense(p["wo"], o.reshape(B, S, num_heads * head_dim))
    cache = None
    if cache_capacity:
        cache = {"k": _ring_store(k, cache_capacity),
                 "v": _ring_store(v, cache_capacity)}
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


def decode_attend(q, cache_k, cache_v, kpos, t, *, scale=None):
    """One-token attention against a cache.

    q: (B, H, D); cache_k/v: (B, C, K, D); kpos: position of each slot,
    (C,) or (B, C); t: current position, scalar or (B,).  Valid slots:
    kpos <= t.
    """
    B, H, D = q.shape
    K = cache_k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), cache_k.float()) * scale
    kb = kpos if kpos.dim() == 2 else kpos[None]             # (1|B, C)
    tq = t.to(torch.int32)
    tb = tq[:, None] if tq.dim() == 1 else tq                # (B, 1) | ()
    s = torch.where((kb <= tb)[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgc,bckd->bkgd", (p / l).to(cache_v.dtype).float(),
                     cache_v.float())
    return o.reshape(B, H, D).to(q.dtype)


def attn_apply_decode(p: PyTree, x: torch.Tensor, cache: PyTree,
                      t: torch.Tensor, *, num_heads: int, num_kv: int,
                      head_dim: int, rope_theta: float = 1e4,
                      use_rope: bool = True, scale: float | None = None,
                      ) -> tuple[torch.Tensor, PyTree]:
    """Decode one token per row.  x: (B, 1, d); t: (B,) per-row positions.

    Row b writes its own ring slot t[b] % C of ``cache`` IN PLACE (the
    reference returns an updated copy; the values are the same) and
    attends at its own position.
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
    o = decode_attend(q[:, 0], cache["k"], cache["v"], kpos, t, scale=scale)
    y = cm.dense(p["wo"], o.reshape(B, 1, num_heads * head_dim))
    return y, cache
