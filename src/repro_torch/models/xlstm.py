"""xLSTM blocks: chunkwise-parallel mLSTM + sequential sLSTM
(arXiv:2405.04517).  Port of ``repro.models.xlstm``, plain torch as the
reference is plain ``jnp`` (no kernel).

mLSTM: matrix memory C (dk x dv) with an exponential input gate and a
sigmoid-in-log-space forget gate; the chunkwise form keeps the exact
max-stabilisation across chunk boundaries (a Python loop over the chunks
where the reference runs ``lax.scan``).  sLSTM: scalar memory with a true
(nonlinear) recurrence on h_{t-1} -> gates, a loop over the time steps.

The reference wraps the sLSTM scan in a ``custom_vjp`` so that, under
``shard_map``, the recurrent weight's gradient is summed once instead of
once a step; on one card there is no such collective, and the port's
backward is autograd's through the time loop (the same chain rule; the
tests hold it against ``jax.grad`` of the reference).  The reference's
``_pvary`` marks operands under ``shard_map`` and has no counterpart here.

Decode updates the state IN PLACE (``state["C"]`` ... ``state["conv"]``;
an sLSTM call with a given state writes its final state into it), as the
serve engine's cache views and CUDA graphs need.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import tape as _tape
from repro_torch.models import common as cm
from repro_torch.models.common import Builder
from repro_torch.models.ssm import conv_full, conv_history, conv_step
from repro_torch.models.ssm import log_sigmoid

PyTree = Any
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(b: Builder, *, d_model: int, num_heads: int,
               proj_factor: float = 2.0, conv_width: int = 4) -> PyTree:
    d_inner = int(d_model * proj_factor)
    return {
        "up": cm.dense_init(b, d_model, 2 * d_inner, ("embed", "ssm")),
        "conv": {"kernel": b.param((conv_width, d_inner), (None, "ssm"),
                                   scale=conv_width ** -0.5),
                 "bias": b.param((d_inner,), ("ssm",), init="zeros")},
        "wq": cm.dense_init(b, d_inner, d_inner, ("ssm", "qkv")),
        "wk": cm.dense_init(b, d_inner, d_inner, ("ssm", "qkv")),
        "wv": cm.dense_init(b, d_inner, d_inner, ("ssm", "qkv")),
        "w_if": cm.dense_init(b, d_inner, 2 * num_heads, ("ssm", None),
                              scale=0.01),
        "if_bias": b.param((2 * num_heads,), (None,), init="zeros"),
        "norm": {"scale": b.param((d_inner,), ("ssm",), init="zeros")},
        "down": cm.dense_init(b, d_inner, d_model, ("ssm", "embed")),
    }


def _mlstm_core_chunked(q, k, v, ig, fg, state, chunk: int):
    """q, k, v: (B,S,H,D); raw gates ig / fg: (B,S,H).  state: (C, n, m)
    or None.  Returns h (B,S,H,D) f32 and the final state.  The exact
    stabilised chunkwise form."""
    B, S, H, D = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is no multiple of the chunk {chunk}")
    nc = S // chunk
    dev = q.device
    q = q.reshape(B, nc, chunk, H, D).float() * D ** -0.5
    k = k.reshape(B, nc, chunk, H, D).float()
    v = v.reshape(B, nc, chunk, H, D).float()
    ig = ig.reshape(B, nc, chunk, H).float()
    logf = log_sigmoid(fg.reshape(B, nc, chunk, H).float())
    F_ = torch.cumsum(logf, dim=2)          # inclusive cumulative log-forget
    if state is None:
        Cp = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
        np_ = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
        mp = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    else:
        Cp, np_, mp = state
    ii = torch.arange(chunk, device=dev)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    hs = []
    for c in range(nc):
        qc, kc, vc, igc, Fc = q[:, c], k[:, c], v[:, c], ig[:, c], F_[:, c]
        # log weight of source i at target t: F_t - F_i + ig_i
        bmat = Fc[:, :, None, :] - Fc[:, None, :, :] + igc[:, None, :, :]
        bmat = torch.where(causal, bmat, -torch.inf)
        a = Fc + mp[:, None, :]              # inter-chunk log weight
        m_row = torch.maximum(bmat.amax(dim=2), a)          # (B,chunk,H)
        w = torch.exp(bmat - m_row[:, :, None, :])          # (B,t,i,H)
        s_inter = torch.exp(a - m_row)
        qk = torch.einsum("bthd,bihd->btih", qc, kc)
        num = torch.einsum("btih,btih,bihd->bthd", qk, w, vc)
        num = num + s_inter[..., None] * torch.einsum("bthd,bhde->bthe",
                                                      qc, Cp)
        den = torch.einsum("btih,btih->bth", qk, w)
        den = den + s_inter * torch.einsum("bthd,bhd->bth", qc, np_)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_row))[..., None])
        # the chunk-end state
        FL = Fc[:, -1]                       # (B, H)
        g_end = FL[:, None, :] - Fc + igc    # log weight to the end
        m_new = torch.maximum(FL + mp, g_end.amax(dim=1))
        wg = torch.exp(g_end - m_new[:, None, :])
        decay = torch.exp(FL + mp - m_new)
        Cp = decay[:, :, None, None] * Cp + torch.einsum(
            "bih,bihd,bihe->bhde", wg, kc, vc)
        np_ = decay[..., None] * np_ + torch.einsum("bih,bihd->bhd", wg, kc)
        mp = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h, (Cp, np_, mp)


def mlstm_core_step(q, k, v, ig, fg, state):
    """One-token recurrent update.  q, k, v: (B,H,D); gates (B,H)."""
    C, n, m = state
    D = q.shape[-1]
    qs = q.float() * D ** -0.5
    logf = log_sigmoid(fg.float())
    m_new = torch.maximum(logf + m, ig.float())
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(logf + m - m_new)
    kf, vf = k.float(), v.float()
    C = f_p[..., None, None] * C + i_p[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n = f_p[..., None] * n + i_p[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.einsum("bhd,bhd->bh", qs, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


def _gates(w, bias, x):
    """sLSTM's dense(w, x) + bias, the bias rounded to bf16 first and the
    sum kept in f32: the reference converts its bf16 sum to f32 at once,
    and XLA's fusion keeps it unrounded (R6).  (mLSTM's gates go through a
    scan's inputs, which hold them in bf16.)"""
    return cm.dense(w, x).float() + bias.to(cm.COMPUTE_DTYPE).float()


def _mlstm_qkvg(p, x_mid, num_heads):
    B, S, d_inner = x_mid.shape
    D = d_inner // num_heads
    q = cm.dense(p["wq"], x_mid).reshape(B, S, num_heads, D)
    k = cm.dense(p["wk"], x_mid).reshape(B, S, num_heads, D)
    v = cm.dense(p["wv"], x_mid).reshape(B, S, num_heads, D)
    gates = cm.dense(p["w_if"], x_mid) + p["if_bias"].to(cm.COMPUTE_DTYPE)
    return q, k, v, gates[..., :num_heads], gates[..., num_heads:]


def _gated_dense(p: PyTree, a: torch.Tensor, b: torch.Tensor):
    """dense(p, a * b).  The jitted reference's stats pass fuses the
    product into the projection's sum of squares and keeps it in f32 there
    (R6, as ``models.mlp.mlp_apply``): the jit tape sees the unrounded
    product."""
    tape_x = None
    if isinstance(_tape.current_tape(), _tape.JitTape):
        tape_x = a.float() * b.float()
    return cm.dense(p, a * b, tape_x=tape_x)


def _mlstm_out(p, h, z, B, S, d_inner):
    h = cm.rmsnorm(p["norm"], h.reshape(B, S, d_inner).to(z.dtype))
    return _gated_dense(p["down"], h, cm.silu(z))


def mlstm_apply_full(p: PyTree, x: torch.Tensor, *, num_heads: int,
                     chunk: int = 256, return_state: bool = False,
                     ) -> tuple[torch.Tensor, PyTree | None]:
    B, S, _ = x.shape
    d_inner = p["conv"]["bias"].shape[0]
    up = cm.dense(p["up"], x)
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    x_mid = conv_full(p, x_in)
    q, k, v, ig, fg = _mlstm_qkvg(p, x_mid, num_heads)
    # pad to a chunk multiple: no-input (ig = -1e30), no-forget (fg = 30)
    ch = min(chunk, S)
    S_pad = -(-S // ch) * ch
    if S_pad != S:
        pq, pg = (0, 0, 0, 0, 0, S_pad - S), (0, 0, 0, S_pad - S)
        q, k, v = F.pad(q, pq), F.pad(k, pq), F.pad(v, pq)
        ig = F.pad(ig, pg, value=NEG_INF)
        fg = F.pad(fg, pg, value=30.0)
    h, state = _mlstm_core_chunked(q, k, v, ig, fg, None, ch)
    out = _mlstm_out(p, h[:, :S], z, B, S, d_inner)
    st = None
    if return_state:
        W = p["conv"]["kernel"].shape[0]
        st = {"C": state[0], "n": state[1], "m": state[2],
              "conv": conv_history(x_in, W)}
    return out, st


def mlstm_init_state(batch: int, *, d_inner: int, num_heads: int,
                     conv_width: int = 4, device, lead: tuple = ()
                     ) -> PyTree:
    D = d_inner // num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*lead, batch, num_heads, D, D), **f32),
        "n": torch.zeros((*lead, batch, num_heads, D), **f32),
        "m": torch.full((*lead, batch, num_heads), NEG_INF, **f32),
        "conv": torch.zeros((*lead, batch, conv_width - 1, d_inner),
                            dtype=torch.bfloat16, device=device),
    }


def mlstm_apply_decode(p: PyTree, x: torch.Tensor, state: PyTree, *,
                       num_heads: int) -> tuple[torch.Tensor, PyTree]:
    """x: (B, 1, d_model); updates ``state`` in place."""
    B = x.shape[0]
    d_inner = p["conv"]["bias"].shape[0]
    up = cm.dense(p["up"], x)
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    hist = torch.cat([state["conv"].to(x_in.dtype), x_in], dim=1)
    x_mid = conv_step(p, hist)[:, None]
    q, k, v, ig, fg = _mlstm_qkvg(p, x_mid, num_heads)
    h, (C, n, m) = mlstm_core_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                   fg[:, 0],
                                   (state["C"], state["n"], state["m"]))
    out = _mlstm_out(p, h[:, None], z, B, 1, d_inner)
    for name, new in (("C", C), ("n", n), ("m", m), ("conv", hist[:, 1:])):
        state[name].copy_(new)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(b: Builder, *, d_model: int, num_heads: int,
               ff_factor: float = 4.0 / 3.0) -> PyTree:
    hd = d_model // num_heads
    d_ff = int(d_model * ff_factor)
    return {
        # input projections for the gates z, i, f, o
        "w_in": cm.dense_init(b, d_model, 4 * d_model, ("embed", "ssm")),
        # block-diagonal recurrent weights per head: (H, hd, 4 hd)
        "r": {"kernel": b.param((num_heads, hd, 4 * hd), (None, None, None),
                                scale=hd ** -0.5)},
        "gate_bias": b.param((4 * d_model,), (None,), init="zeros"),
        "norm": {"scale": b.param((d_model,), ("embed_act",),
                                  init="zeros")},
        "ff_up": cm.dense_init(b, d_model, 2 * d_ff, ("embed", "mlp")),
        "ff_down": cm.dense_init(b, d_ff, d_model, ("mlp", "embed")),
    }


def _slstm_step(carry, g_t, r, num_heads):
    """One time step: carry (c, n, m, h_prev), each (B, H, hd) f32; g_t
    (B, 4 d) f32; r (H, hd, 4 hd) f32."""
    c, n, m, h_prev = carry
    B, hd = g_t.shape[0], c.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", h_prev, r)       # (B, H, 4 hd)
    g = g_t.reshape(B, num_heads, 4, hd).transpose(2, 3)
    g = g + rec.reshape(B, num_heads, hd, 4)
    zt = torch.tanh(g[..., 0])
    it = g[..., 1]
    logf = log_sigmoid(g[..., 2])
    ot = torch.sigmoid(g[..., 3])
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = torch.clamp_min(f_p * n + i_p, 1e-6)
    h = ot * c_new / n_new
    return c_new, n_new, m_new, h


def slstm_core(p: PyTree, gates_in: torch.Tensor, state: PyTree, *,
               num_heads: int):
    """The sequential scan: gates_in (B, S, 4 d) -> (h (B, S, d) f32, the
    final state dict)."""
    B, S, d4 = gates_in.shape
    r = p["r"]["kernel"].float()
    g = gates_in.float()
    carry = (state["c"], state["n"], state["m"], state["h"])
    hs = []
    for t in range(S):
        carry = _slstm_step(carry, g[:, t], r, num_heads)
        hs.append(carry[3])
    h = torch.stack(hs, dim=1).reshape(B, S, d4 // 4)
    return h, dict(zip(("c", "n", "m", "h"), carry))


def slstm_init_state(batch: int, *, d_model: int, num_heads: int, device,
                     lead: tuple = ()) -> PyTree:
    hd = d_model // num_heads
    shape = (*lead, batch, num_heads, hd)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32),
            "n": torch.full(shape, 1e-6, **f32),
            "m": torch.full(shape, NEG_INF, **f32),
            "h": torch.zeros(shape, **f32)}


def slstm_apply(p: PyTree, x: torch.Tensor, state: PyTree | None, *,
                num_heads: int, return_state: bool = False,
                ) -> tuple[torch.Tensor, PyTree | None]:
    """The sLSTM block body from state (None: the initial state).  A given
    ``state`` is updated in place to the final state."""
    B, S, d = x.shape
    given = state is not None
    if not given:
        state = slstm_init_state(B, d_model=d, num_heads=num_heads,
                                 device=x.device)
    gates_in = _gates(p["w_in"], p["gate_bias"], x)
    h, new_state = slstm_core(p, gates_in, state, num_heads=num_heads)
    if given:
        for name, new in new_state.items():
            state[name].copy_(new)
        new_state = state
    h = cm.rmsnorm(p["norm"], h.to(x.dtype))
    ff = cm.dense(p["ff_up"], h)
    d_ff = ff.shape[-1] // 2
    h = _gated_dense(p["ff_down"], cm.gelu(ff[..., :d_ff]), ff[..., d_ff:])
    return h, (new_state if return_state else None)
