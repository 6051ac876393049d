"""Attention: GQA + RoPE + sliding window + softcap + QK-norm, and
DeepSeek-V2's multi-head latent attention (MLA).  Port of
``repro.models.attention``: the ``attn`` and ``local`` kinds (global and
sliding-window causal attention, gemma's logit softcap and QK-norm),
whisper's non-causal encoder attention and its cross-attention over K/V
computed elsewhere (``kv_override``), and the ``mla_*`` kinds' attention
(:func:`mla_apply_full`, and the absorbed c-space decode and verify,
plain torch as the reference's ``jnp``).

Two execution paths (and :func:`reference_attention`, the reference's
materialised oracle, for tests):

* :func:`flash_attention` - prefill and calibration, plain torch as in
  the reference, which leaves it to XLA.  The reference's
  chunked online-softmax forward (query blocks in a Python loop,
  triangle-exact under the causal mask, every kv block without it; kv
  blocks with a running
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
    PV.  A softcapped layer (gemma2) always takes it, whatever
    ``kv_shards`` says, as the reference stays on its replicated branch
    under a softcap (``attention.py:354``);
  - ``1``: the ``flash_decode`` kernel (``ops.py:76 decode_attention``),
    f32 probabilities;
  - ``S >= 2``: the reference's tensor-parallel branch on a mesh with
    ``model = S`` (``kernels/shard.py decode_attend_sharded``): the
    ``flash_decode_partial`` kernel over S capacity shards, then the
    combine kernel.

  Under rules (tensor parallelism across ranks) a ring whose capacity is
  sharded over "model" (``kernels.shard.ring_layout``, as
  ``attention.py:355-372`` dispatches) holds this rank's slots only: the
  decode step writes a row's new slot on the rank that holds it and runs
  ``decode_attend_sharded`` across the ranks.

bf16 einsums in torch return bf16, where JAX's
``preferred_element_type=float32`` returns f32, so operands are upcast to
f32 wherever the reference keeps an f32 result.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import shard as ksh
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.observe import f32_accumulation
from repro_torch.models import common as cm
from repro_torch.models.common import Builder

PyTree = Any
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Flash attention (forward; backward under autograd)
# ---------------------------------------------------------------------------

def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, *,
               window: int = 0, causal: bool = True) -> torch.Tensor:
    """Additive causal (and sliding-window) mask bias, 0 or NEG_INF; all 0
    when neither ``causal`` nor ``window`` masks.  qpos: (Sq,), kpos:
    (Sk,)."""
    ok = (kpos[None, :] <= qpos[:, None] if causal else
          torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                     device=qpos.device))
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def _qk(q: torch.Tensor, k: torch.Tensor, scale: float,
        softcap: float = 0.0) -> torch.Tensor:
    # q: (B, Sq, K, G, D)  k: (B, Sk, K, D) -> (B, K, G, Sq, Sk) fp32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    return cm.softcap(s, softcap)


def _flash_fwd_block(q_blk, k, v, *, qpos, scale, kv_block, window,
                     softcap=0.0, causal=True):
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
        s = _qk(q_blk, k[:, sl], scale, softcap)
        s = s + _mask_bias(qpos, kpos, window=window,
                           causal=causal)[None, None, None]
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


def _q_blocks(Sq, Sk, q_block, kv_block, device, causal=True):
    """(query slice, qpos, visible kv length n) per query block: under the
    causal mask only kv blocks whose start can be visible (static bound),
    else every whole kv block."""
    for iq in range(Sq // q_block):
        qpos = (Sk - Sq) + iq * q_block + torch.arange(q_block, device=device)
        if causal:
            hi = min(Sk, (Sk - Sq) + (iq + 1) * q_block)
            n = -(-hi // kv_block) * kv_block
        else:
            n = Sk // kv_block * kv_block
        yield slice(iq * q_block, (iq + 1) * q_block), qpos, n


def _flash_fwd(q, k, v, causal, window, softcap, scale, q_block, kv_block):
    """Grouped q (B,Sq,K,G,D) -> (out in q.dtype, logsumexp L (B,K,G,Sq))."""
    os_, Ls = [], []
    for sl, qpos, n in _q_blocks(q.shape[1], k.shape[1], q_block, kv_block,
                                 q.device, causal):
        o, m, l = _flash_fwd_block(q[:, sl], k[:, :n], v[:, :n], qpos=qpos,
                                   scale=scale, kv_block=kv_block,
                                   window=window, softcap=softcap,
                                   causal=causal)
        os_.append(o)
        Ls.append(m + torch.log(torch.clamp_min(l, 1e-30)))
    return torch.cat(os_, dim=1).to(q.dtype), torch.cat(Ls, dim=3)


def _flash_bwd_block(q_blk, k, v, o_blk, L_blk, do_blk, *, qpos, scale,
                     kv_block, window, softcap=0.0, causal=True):
    """Backward for one query block: (dq_blk, dk, dv), f32, dk/dv over the
    block's visible kv length.  Under a softcap the logits are
    t * cap with t = tanh(raw / cap), and ds takes the factor 1 - t t."""
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
        if softcap:
            t = torch.tanh(s / torch.full((), softcap, device=dev))
            s = t * softcap
        bias = _mask_bias(qpos, kpos, window=window,
                          causal=causal)[None, None, None]
        p = torch.exp(s + bias - L_blk[..., None])          # (B,K,G,Sq,Sk)
        dp = torch.einsum("bqkgd,bskd->bkgqs", do_f, vs)
        dv[:, sl] += torch.einsum("bkgqs,bqkgd->bskd", p, do_f)
        ds = p * (dp - Drow[..., None])
        if softcap:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq += torch.einsum("bkgqs,bskd->bqkgd", ds, ks)
        dk[:, sl] += torch.einsum("bkgqs,bqkgd->bskd", ds, q_blk.float())
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` ``_flash``: forward saves
    (q, k, v, out, L); backward recomputes the probabilities in f32 per
    query block and kv block (nothing quadratic is saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_block,
                kv_block):
        out, L = _flash_fwd(q, k, v, causal, window, softcap, scale, q_block,
                            kv_block)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.cfg = (causal, window, softcap, scale, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, L = ctx.saved_tensors
        causal, window, softcap, scale, q_block, kv_block = ctx.cfg
        dqs = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for sl, qpos, n in _q_blocks(q.shape[1], k.shape[1], q_block,
                                     kv_block, q.device, causal):
            dq_blk, dk_p, dv_p = _flash_bwd_block(
                q[:, sl], k[:, :n], v[:, :n], out[:, sl], L[..., sl],
                do[:, sl], qpos=qpos, scale=scale, kv_block=kv_block,
                window=window, softcap=softcap, causal=causal)
            dqs.append(dq_blk)
            dk[:, :n] += dk_p
            dv[:, :n] += dv_p
        return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                    scale=None, q_block=None, kv_block=None):
    """Causal attention (``causal=False``: every query sees every key, as
    whisper's encoder and its cross-attention, where Sq may differ from
    Sk), over the last ``window`` positions when window > 0, logits
    softcapped at ``attn_softcap`` when set.  q: (B,Sq,H,D) or
    (B,Sq,K,G,D); k,v: (B,Sk,K,D).  Sq and Sk must be multiples of their
    blocks (512 or less), as the reference asserts.  Returns (B,Sq,H,Dv)
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
        out = _Flash.apply(q, k, v, causal, window, attn_softcap, scale,
                           q_block, kv_block)
    else:
        out = torch.cat([
            _flash_fwd_block(q[:, sl], k[:, :n], v[:, :n], qpos=qpos,
                             scale=scale, kv_block=kv_block, window=window,
                             softcap=attn_softcap, causal=causal)[0]
            for sl, qpos, n in _q_blocks(Sq, Sk, q_block, kv_block,
                                         q.device, causal)],
            dim=1).to(q.dtype)
    return out.reshape(B, Sq, K * G, v.shape[-1]) if squeeze else out


def reference_attention(q, k, v, *, causal=True, window=0,
                        attn_softcap=0.0, scale=None):
    """The reference's materialised-logits oracle (``attention.py:216``):
    the causal (or not) and windowed softmax over all f32 logits at once,
    softcapped where set, the probabilities rounded to v's dtype before
    PV.  q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,Dv) in v's dtype."""
    B, Sq, H, D = q.shape
    K, Sk = k.shape[2], k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    s = _qk(q.reshape(B, Sq, K, H // K, D), k, scale, attn_softcap)
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    s = s + _mask_bias(qpos, torch.arange(Sk, device=q.device),
                       window=window, causal=causal)[None, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(v.dtype)


# ---------------------------------------------------------------------------
# Standard attention module (init/apply)
# ---------------------------------------------------------------------------

def attn_init(b: Builder, *, d_model: int, num_heads: int, num_kv: int,
              head_dim: int, qk_norm: bool = False) -> PyTree:
    h, kv = num_heads * head_dim, num_kv * head_dim
    p = {
        "wq": cm.dense_init(b, d_model, h, ("embed", "qkv")),
        "wk": cm.dense_init(b, d_model, kv, ("embed", "qkv")),
        "wv": cm.dense_init(b, d_model, kv, ("embed", "qkv")),
        "wo": cm.dense_init(b, h, d_model, ("qkv", "embed")),
    }
    if qk_norm:    # gemma3: per-head RMSNorm of q and k, scales over D
        p["q_norm"] = {"scale": b.param((head_dim,), (None,), init="zeros")}
        p["k_norm"] = {"scale": b.param((head_dim,), (None,), init="zeros")}
    return p


def _qk_normed(p: PyTree, q: torch.Tensor, k: torch.Tensor):
    """q and k through their RMSNorms (over the head dim), when the layer
    has them (``qk_norm``); before rope, as the reference."""
    if "q_norm" in p:
        q = cm.rmsnorm(p["q_norm"], q)
        k = cm.rmsnorm(p["k_norm"], k)
    return q, k


def _qkv(p: PyTree, x: torch.Tensor, qkv_delta=None):
    """The q, k and v projections of x, each plus its delta where
    ``qkv_delta`` gives them (bf16 adds, as the reference's)."""
    out = [cm.dense(p[n], x) for n in ("wq", "wk", "wv")]
    if qkv_delta is not None:
        out = [o + d for o, d in zip(out, qkv_delta, strict=True)]
    return out


def make_kv_cache(batch: int, capacity: int, num_kv: int, head_dim: int, *,
                  device, lead: tuple = (),
                  dtype: torch.dtype = torch.bfloat16) -> PyTree:
    shape = (*lead, batch, capacity, num_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_apply_full(p: PyTree, x: torch.Tensor, *, positions: torch.Tensor,
                    num_heads: int, num_kv: int, head_dim: int,
                    rope_theta: float = 1e4, use_rope: bool = True,
                    causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0, scale: float | None = None,
                    cache_capacity: int = 0, kv_override=None,
                    qkv_delta=None,
                    ) -> tuple[torch.Tensor, PyTree | None]:
    """Prefill path. Returns (y, kv_cache or None); a windowed layer's
    cache ring holds min(cache_capacity, window) slots.  ``causal=False``:
    whisper's encoder.  ``kv_override``: (k, v) (B, Sk, K, D) computed
    elsewhere (whisper's cross-attention over the encoder output): wk and
    wv are not applied and k takes no rope.  ``qkv_delta``: (dq, dk, dv)
    added to the projections before rope (zamba2's LoRA on its shared
    block)."""
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _qkv(p, x, qkv_delta)
        k = k.reshape(B, S, num_kv, head_dim)
        v = v.reshape(B, S, num_kv, head_dim)
    else:
        q = cm.dense(p["wq"], x)
        if qkv_delta is not None:
            q = q + qkv_delta[0]
        k, v = kv_override
    q = q.reshape(B, S, num_heads, head_dim)
    q, k = _qk_normed(p, q, k)
    if use_rope:
        q = cm.rope(q, positions, theta=rope_theta)
        if kv_override is None:
            k = cm.rope(k, positions, theta=rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        attn_softcap=attn_softcap, scale=scale)
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


def decode_attend(q, cache_k, cache_v, kpos, t, *, attn_softcap=0.0,
                  scale=None, window=0, kv_shards=None, kv_axes=()):
    """One-token attention against a cache.

    q: (B, H, D); cache_k/v: (B, C, K, D); kpos: position of each slot,
    (C,) or (B, C); t: current position, scalar or (B,).  Valid slots:
    kpos <= t, and t - kpos < window when window > 0.  ``kv_shards``: None
    (replicated, plain torch), 1 (``flash_decode``) or S >= 2 dividing C
    (S capacity shards, ``flash_decode_partial`` + combine); see the
    module docstring.  Softcapped logits (``attn_softcap``) take the
    replicated path at any ``kv_shards``, as in the reference.
    ``kv_axes``: the cache is this rank's capacity block, sharded over
    those mesh axes (``kpos`` its slots' positions), attended across the
    ranks.
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
    if kv_axes:
        if attn_softcap:
            raise NotImplementedError(
                "softcapped decode attention over a capacity-sharded ring "
                "(ROADMAP A item 3)")
        o = ksh.decode_attend_sharded(qg, cache_k, cache_v,
                                      ok.expand(B, cache_k.shape[1]),
                                      axes=kv_axes, scale=scale)
        return o.reshape(B, H, cache_v.shape[-1]).to(q.dtype)
    if kv_shards is not None and not attn_softcap:
        ksh.check_kv_shards(kv_shards, (cache_k.shape[1],))
        ok = ok.expand(B, cache_k.shape[1])
        if kv_shards == 1:
            bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
            o = flash_decode(qg, cache_k, cache_v, bias, scale=scale)
        else:
            o = ksh.decode_attend_sharded(qg, cache_k, cache_v, ok,
                                          shards=kv_shards, scale=scale)
        return o.reshape(B, H, cache_v.shape[-1]).to(q.dtype)
    # f32 operand copies: the reference's einsums accumulate bf16 in f32
    # (preferred_element_type), which a torch product cannot ask for
    with f32_accumulation():
        s = torch.einsum("bkgd,bckd->bkgc", qg.float(),
                         cache_k.float()) * scale
    s = cm.softcap(s, attn_softcap)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    with f32_accumulation():
        o = torch.einsum("bkgc,bckd->bkgd",
                         (p / l).to(cache_v.dtype).float(), cache_v.float())
    return o.reshape(B, H, D).to(q.dtype)


def attn_apply_decode(p: PyTree, x: torch.Tensor, cache: PyTree,
                      t: torch.Tensor, *, num_heads: int, num_kv: int,
                      head_dim: int, rope_theta: float = 1e4,
                      use_rope: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, scale: float | None = None,
                      kv_shards: int | None = None, qkv_delta=None,
                      ) -> tuple[torch.Tensor, PyTree]:
    """Decode one token per row.  x: (B, 1, d); t: (B,) per-row positions.

    Row b writes its own ring slot t[b] % C of ``cache`` IN PLACE (the
    reference returns an updated copy; the values are the same) and
    attends at its own position, through :func:`decode_attend`'s
    ``kv_shards`` path.  ``qkv_delta``: as :func:`attn_apply_full`.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    C = cache["k"].shape[1]
    q, k, v = _qkv(p, x, qkv_delta)
    q = q.reshape(B, 1, num_heads, head_dim)
    k = k.reshape(B, 1, num_kv, head_dim)
    v = v.reshape(B, 1, num_kv, head_dim)
    q, k = _qk_normed(p, q, k)
    if use_rope:
        q = cm.rope(q, t[:, None], theta=rope_theta)
        k = cm.rope(k, t[:, None], theta=rope_theta)
    rows = torch.arange(B, device=x.device)
    lay = ksh.ring_layout(B, C, window)
    if lay is None:
        slot = ring_slot(t, C).long()
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        kpos, kv_axes = ring_positions(t, C), ()
    else:
        # this rank holds slots [off, off + C) of the whole ring's
        kv_axes, whole, off = lay
        slot = ring_slot(t, whole).long() - off
        mine = ((slot >= 0) & (slot < C))[:, None, None]
        slot = slot.clamp(0, C - 1)
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c[rows, slot] = torch.where(mine, new[:, 0].to(c.dtype),
                                        c[rows, slot])
        kpos = ring_positions(t, whole)[:, off:off + C]
    o = decode_attend(q[:, 0], cache["k"], cache["v"], kpos, t,
                      attn_softcap=attn_softcap, scale=scale, window=window,
                      kv_shards=kv_shards, kv_axes=kv_axes)
    y = cm.dense(p["wo"], o.reshape(B, 1, num_heads * head_dim))
    return y, cache


def attn_apply_verify(p: PyTree, x: torch.Tensor, cache: PyTree,
                      t: torch.Tensor, *, num_heads: int, num_kv: int,
                      head_dim: int, rope_theta: float = 1e4,
                      use_rope: bool = True, attn_softcap: float = 0.0,
                      scale: float | None = None,
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
    if ksh.ring_layout(B, C) is not None:
        raise NotImplementedError(
            "spec verify over a capacity-sharded ring (tensor parallelism) "
            "is not ported: ROADMAP A item 3")
    q = cm.dense(p["wq"], x).reshape(B, S, num_heads, head_dim)
    k = cm.dense(p["wk"], x).reshape(B, S, num_kv, head_dim)
    v = cm.dense(p["wv"], x).reshape(B, S, num_kv, head_dim)
    q, k = _qk_normed(p, q, k)
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
    s = cm.softcap(s, attn_softcap)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(b: Builder, *, d_model: int, num_heads: int, kv_lora: int,
             nope_dim: int = 128, rope_dim: int = 64, v_dim: int = 128
             ) -> PyTree:
    return {
        "wq": cm.dense_init(b, d_model, num_heads * (nope_dim + rope_dim),
                            ("embed", "qkv")),
        "w_dkv": cm.dense_init(b, d_model, kv_lora + rope_dim,
                               ("embed", None)),
        "kv_norm": {"scale": b.param((kv_lora,), (None,), init="zeros")},
        "w_uk": cm.dense_init(b, kv_lora, num_heads * nope_dim,
                              (None, "qkv")),
        "w_uv": cm.dense_init(b, kv_lora, num_heads * v_dim, (None, "qkv")),
        "wo": cm.dense_init(b, num_heads * v_dim, d_model, ("qkv", "embed")),
    }


def make_mla_cache(batch: int, capacity: int, kv_lora: int, rope_dim: int,
                   *, device, lead: tuple = ()) -> PyTree:
    """The MLA ring: the normalised latent ``ckv`` and the one shared rope
    key ``krope`` per slot, bf16."""
    return {"ckv": torch.zeros((*lead, batch, capacity, kv_lora),
                               dtype=torch.bfloat16, device=device),
            "krope": torch.zeros((*lead, batch, capacity, rope_dim),
                                 dtype=torch.bfloat16, device=device)}


def _mla_qkr(p: PyTree, x: torch.Tensor, pos: torch.Tensor, *,
             num_heads: int, kv_lora: int, nope_dim: int, rope_dim: int,
             rope_theta: float):
    """The projections every MLA path shares: (q_nope (B,S,H,nope), roped
    q_rope (B,S,H,rope), c_kv (B,S,kv_lora), roped k_rope (B,S,rope)), all
    in x's dtype.  pos: (B, S)."""
    B, S, _ = x.shape
    q = cm.dense(p["wq"], x).reshape(B, S, num_heads, nope_dim + rope_dim)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    q_rope = cm.rope(q_rope, pos, theta=rope_theta)
    ckr = cm.dense(p["w_dkv"], x)
    c_kv = cm.rmsnorm(p["kv_norm"], ckr[..., :kv_lora])
    k_rope = cm.rope(ckr[..., kv_lora:][:, :, None, :], pos,
                     theta=rope_theta)[:, :, 0]   # one head shared by all H
    return q_nope, q_rope, c_kv, k_rope


def mla_apply_full(p: PyTree, x: torch.Tensor, *, positions: torch.Tensor,
                   num_heads: int, kv_lora: int, nope_dim: int = 128,
                   rope_dim: int = 64, v_dim: int = 128,
                   rope_theta: float = 1e4, cache_capacity: int = 0,
                   ) -> tuple[torch.Tensor, PyTree | None]:
    """Prefill path: k_nope and v up-projected from the latent, the shared
    rope key broadcast to every head, causal attention over the concat
    nope|rope at scale (nope + rope) ** -0.5 (qk width nope + rope, v width
    v_dim).  Returns (y, {"ckv", "krope"} ring or None)."""
    B, S, _ = x.shape
    H = num_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(
        p, x, positions, num_heads=H, kv_lora=kv_lora, nope_dim=nope_dim,
        rope_dim=rope_dim, rope_theta=rope_theta)
    k_nope = cm.dense(p["w_uk"], c_kv).reshape(B, S, H, nope_dim)
    v = cm.dense(p["w_uv"], c_kv).reshape(B, S, H, v_dim)
    qc = torch.cat([q_nope, q_rope], dim=-1)
    kc = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rope_dim)],
                   dim=-1)
    o = flash_attention(qc, kc, v, scale=(nope_dim + rope_dim) ** -0.5)
    y = cm.dense(p["wo"], o.reshape(B, S, H * v_dim))
    cache = None
    if cache_capacity:
        cache = {"ckv": _ring_store(c_kv, cache_capacity),
                 "krope": _ring_store(k_rope, cache_capacity)}
    return y, cache


def _mla_absorbed(p: PyTree, q_nope, q_rope, cache: PyTree,
                  pos: torch.Tensor, *, num_heads: int, kv_lora: int,
                  nope_dim: int, rope_dim: int, v_dim: int) -> torch.Tensor:
    """Attention in the compressed c-space over the whole ring, the
    reference's absorbed-matmul decode with its roundings: q_c = q_nope
    W_uk in f32 (W_uk read dense in f32, :func:`common.kernel_dense`),
    scores from bf16 operands with f32 sums (the rope term added in f32),
    scaled, masked to ring positions <= each query's position, an f32
    softmax, probabilities rounded to bf16 for o_c, W_uv absorbed in f32,
    the result rounded to bf16.  q_nope (B,S,H,nope), q_rope (B,S,H,rope),
    pos (B,S) -> (B, S, H * v_dim) bf16."""
    B, S, H, _ = q_nope.shape
    C = cache["ckv"].shape[1]
    ckv, krope = cache["ckv"].float(), cache["krope"].float()
    w_uk = cm.kernel_dense(p["w_uk"]).float().reshape(kv_lora, H, nope_dim)
    q_c = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
    s = torch.einsum("bshr,bcr->bshc", q_c.to(torch.bfloat16).float(), ckv)
    s = s + torch.einsum("bshr,bcr->bshc",
                         q_rope.to(torch.bfloat16).float(), krope)
    s = s * (nope_dim + rope_dim) ** -0.5
    kpos = ring_positions(pos[:, -1], C)                         # (B, C)
    ok = kpos[:, None, :] <= pos[:, :, None]                     # (B, S, C)
    s = torch.where(ok[:, :, None, :], s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pr = e / e.sum(dim=-1, keepdim=True)
    o_c = torch.einsum("bshc,bcr->bshr", pr.to(torch.bfloat16).float(), ckv)
    w_uv = cm.kernel_dense(p["w_uv"]).float().reshape(kv_lora, H, v_dim)
    o = torch.einsum("bshr,rhd->bshd", o_c, w_uv)
    return o.reshape(B, S, H * v_dim).to(torch.bfloat16)


def mla_apply_decode(p: PyTree, x: torch.Tensor, cache: PyTree,
                     t: torch.Tensor, *, num_heads: int, kv_lora: int,
                     nope_dim: int = 128, rope_dim: int = 64,
                     v_dim: int = 128, rope_theta: float = 1e4,
                     ) -> tuple[torch.Tensor, PyTree]:
    """Absorbed-matmul decode, one token per row.  x: (B, 1, d); t: (B,)
    per-row positions.  Row b writes its ring slot t[b] % C of ``cache`` in
    place, then attends at its own position (:func:`_mla_absorbed`)."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    return mla_apply_verify(p, x, cache, t, num_heads=num_heads,
                            kv_lora=kv_lora, nope_dim=nope_dim,
                            rope_dim=rope_dim, v_dim=v_dim,
                            rope_theta=rope_theta)


def mla_apply_verify(p: PyTree, x: torch.Tensor, cache: PyTree,
                     t: torch.Tensor, *, num_heads: int, kv_lora: int,
                     nope_dim: int = 128, rope_dim: int = 64,
                     v_dim: int = 128, rope_theta: float = 1e4,
                     ) -> tuple[torch.Tensor, PyTree]:
    """Teacher-forced S-token absorbed-matmul decode (speculative verify).

    x: (B, S, d); t: (B,) per-row start positions.  All S c-space rows are
    written first (in place), then query i masks ring positions <= t + i,
    as :func:`attn_apply_verify`.  The caller guarantees max(t) + S <=
    capacity (no ring wrap)."""
    B, S, _ = x.shape
    C = cache["ckv"].shape[1]
    pos = t.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=x.device)                  # (B, S)
    q_nope, q_rope, c_new, k_rope = _mla_qkr(
        p, x, pos, num_heads=num_heads, kv_lora=kv_lora, nope_dim=nope_dim,
        rope_dim=rope_dim, rope_theta=rope_theta)
    rows = torch.arange(B, device=x.device)[:, None]
    slot = ring_slot(pos, C).long()
    cache["ckv"][rows, slot] = c_new.to(cache["ckv"].dtype)
    cache["krope"][rows, slot] = k_rope.to(cache["krope"].dtype)
    o = _mla_absorbed(p, q_nope, q_rope, cache, pos, num_heads=num_heads,
                      kv_lora=kv_lora, nope_dim=nope_dim, rope_dim=rope_dim,
                      v_dim=v_dim)
    return cm.dense(p["wo"], o), cache
