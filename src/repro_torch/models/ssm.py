"""Mamba-2 (SSD) block: chunked-parallel prefill form + O(1) decode step.
Port of ``repro.models.ssm``, plain torch as the reference is plain
``jnp`` (no kernel).

Chunked SSD (Dao & Gu, arXiv:2405.21060): within a chunk the output is a
masked quadratic form (attention-like, cost S*L per token); across chunks a
short scan propagates the (heads, head_dim, state) SSM state.  The
reference combines the chunk states with ``jax.lax.associative_scan``; the
port runs the same combine as a sequential loop over the chunks.  Both are
f32, so the states differ by f32 rounding only (the tests hold the
outputs to bf16 ulps, not bits).

Roundings follow the jitted reference (ROADMAP R6): the in-projection
and the causal conv run in bf16, each product and partial sum of the
conv rounded (XLA keeps those converts; the decode step's ``einsum`` sums
in f32 and rounds once); the SSD math (softplus, the decays ``exp`` of
cumulative-sum differences, the chunk states) in f32; the gated output
``y * silu(z)`` enters the norm as the f32 product of its bf16 factors,
unrounded, as XLA's fusion keeps it.

Decode updates the state IN PLACE (``state["h"]``, ``state["conv"]``): the
serve engine's layer loop hands each layer a view of its cache, and a CUDA
graph replays the update into the same buffers.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import Builder

PyTree = Any


def mamba2_init(b: Builder, *, d_model: int, d_inner: int, d_state: int,
                head_dim: int = 64, conv_width: int = 4) -> PyTree:
    nh = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (ds), C (ds), dt (nh)]
        "in_proj": cm.dense_init(b, d_model, 2 * d_inner + 2 * d_state + nh,
                                 ("embed", "ssm")),
        "conv": {"kernel": b.param((conv_width, conv_ch), (None, "ssm"),
                                   scale=conv_width ** -0.5),
                 "bias": b.param((conv_ch,), ("ssm",), init="zeros")},
        "A_log": b.param((nh,), (None,), init="uniform", scale=1.0),
        "dt_bias": b.param((nh,), (None,), init="zeros"),
        "D": b.param((nh,), (None,), init="ones"),
        "norm": {"scale": b.param((d_inner,), ("ssm",), init="zeros")},
        "out_proj": cm.dense_init(b, d_inner, d_model, ("ssm", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def _split(p, x, d_inner, d_state):
    zxbcdt = cm.dense(p["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    xin = zxbcdt[..., d_inner:2 * d_inner]
    Bm = zxbcdt[..., 2 * d_inner:2 * d_inner + d_state]
    Cm = zxbcdt[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, xin, Bm, Cm, dt


def conv_full(p, u: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d over the sequence, then silu.  u: (B, S, C)
    in bf16.  Each of the W shifted products and each partial sum rounds
    to u's dtype, as the jitted reference's fused chain does (XLA keeps
    its bf16 converts there)."""
    w = p["conv"]["kernel"].to(u.dtype)                  # (W, C)
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S] * w[i]
    return cm.silu(out + p["conv"]["bias"].to(u.dtype))


def conv_history(u: torch.Tensor, W: int) -> torch.Tensor:
    """The last W - 1 rows of u (B, S, C) as a decode conv cache, bf16;
    zero rows in front where S < W - 1, as W - 1 - S blank decode steps
    would leave them."""
    h = u[:, max(0, u.shape[1] - (W - 1)):]
    return F.pad(h, (0, 0, W - 1 - h.shape[1], 0)).to(torch.bfloat16)


def conv_step(p, hist: torch.Tensor) -> torch.Tensor:
    """One decode step of the conv: hist (B, W, C) bf16, the last row the
    new input -> silu(sum_w hist w + bias) (B, C) in hist's dtype; the
    products summed in f32, rounded once."""
    w = p["conv"]["kernel"].to(hist.dtype).float()
    out = (hist.float() * w).sum(dim=1)
    out = out.to(hist.dtype) + p["conv"]["bias"].to(hist.dtype)
    return cm.silu(out)


def _gated_out(p, y, z):
    """out_proj(norm(y * silu(z))): the bf16 y and silu(z) multiplied in
    f32 into the norm, unrounded, as XLA's fusion keeps the product
    (R6); the norm's output in bf16."""
    y = cm.rmsnorm(p["norm"], y.float() * cm.silu(z).float())
    return cm.dense(p["out_proj"], y.to(z.dtype))


def _dt(p, dt: torch.Tensor) -> torch.Tensor:
    dt = softplus(dt.float() + p["dt_bias"].float())
    return torch.clamp(dt, 1e-4, 10.0)


def mamba2_apply_full(p: PyTree, x: torch.Tensor, *, d_inner: int,
                      d_state: int, head_dim: int = 64, chunk: int = 256,
                      return_state: bool = False,
                      ) -> tuple[torch.Tensor, PyTree | None]:
    B, S_real, _ = x.shape
    nh = d_inner // head_dim
    z, xin, Bm, Cm, dt = _split(p, x, d_inner, d_state)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = conv_full(p, conv_in)
    xin = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + d_state]
    Cm = conv_out[..., d_inner + d_state:]

    A = -torch.exp(p["A_log"].float())                 # (nh,) negative
    dt = _dt(p, dt)                                     # (B, S, nh)

    # pad to a chunk multiple with dt = 0 steps (a = 1, zero input: the
    # state is unchanged)
    chunk = min(chunk, S_real)
    S = -(-S_real // chunk) * chunk
    if S != S_real:
        pad = (0, 0, 0, S - S_real)
        xin, Bm, Cm = F.pad(xin, pad), F.pad(Bm, pad), F.pad(Cm, pad)
        dt = F.pad(dt, pad)
    nc = S // chunk
    xh = xin.reshape(B, nc, chunk, nh, head_dim).float()
    Bc = Bm.reshape(B, nc, chunk, d_state).float()
    Cc = Cm.reshape(B, nc, chunk, d_state).float()
    dtc = dt.reshape(B, nc, chunk, nh)

    loga = dtc * A                                      # log decay a step
    cum = torch.cumsum(loga, dim=2)                     # inclusive l_t
    # intra-chunk: y[t] = sum_{i<=t} exp(l_t - l_i) dt_i (C_t.B_i) x_i
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)         # (B, nc, L, L)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    M = torch.where(causal, torch.exp(diff), 0.0) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcls,bclsh,bcshp->bclhp", G, M, xh)

    # chunk states: S_c = sum_i exp(l_last - l_i) dt_i B_i x_i^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B, nc, L, nh)
    Sc = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, decay_to_end * dtc, xh)
    A_chunk = torch.exp(cum[:, :, -1, :])               # (B, nc, nh)
    # the state before each chunk, then the final one
    h = torch.zeros_like(Sc[:, 0])
    prev = []
    for c in range(nc):
        prev.append(h)
        h = A_chunk[:, c][..., None, None] * h + Sc[:, c]
    H_prev = torch.stack(prev, dim=1)
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cc, torch.exp(cum),
                           H_prev)

    y = (y_intra + y_inter).reshape(B, S, nh, head_dim)
    y = y + p["D"].float()[None, None, :, None] * \
        xin.reshape(B, S, nh, head_dim).float()
    y = y.reshape(B, S, d_inner)[:, :S_real].to(x.dtype)
    out = _gated_out(p, y, z)

    state = None
    if return_state:
        W = p["conv"]["kernel"].shape[0]
        state = {"h": h, "conv": conv_history(conv_in, W)}
    return out, state


def mamba2_init_state(batch: int, *, d_inner: int, d_state: int,
                      head_dim: int = 64, conv_width: int = 4, device,
                      lead: tuple = ()) -> PyTree:
    nh = d_inner // head_dim
    return {
        "h": torch.zeros((*lead, batch, nh, head_dim, d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, conv_width - 1,
                             d_inner + 2 * d_state),
                            dtype=torch.bfloat16, device=device),
    }


def mamba2_apply_decode(p: PyTree, x: torch.Tensor, state: PyTree, *,
                        d_inner: int, d_state: int, head_dim: int = 64,
                        ) -> tuple[torch.Tensor, PyTree]:
    """x: (B, 1, d_model).  O(1) recurrent update of ``state``, in place."""
    B = x.shape[0]
    nh = d_inner // head_dim
    z, xin, Bm, Cm, dt = _split(p, x, d_inner, d_state)
    u = torch.cat([xin, Bm, Cm], dim=-1)                # (B, 1, C)
    hist = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    conv_out = conv_step(p, hist)
    xv = conv_out[:, :d_inner].reshape(B, nh, head_dim).float()
    Bv = conv_out[:, d_inner:d_inner + d_state].float()
    Cv = conv_out[:, d_inner + d_state:].float()

    A = -torch.exp(p["A_log"].float())
    dtv = _dt(p, dt[:, 0])                              # (B, nh)
    a = torch.exp(dtv * A)
    h = state["h"] * a[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xv, Bv)
    y = torch.einsum("bhpn,bn->bhp", h, Cv) + \
        p["D"].float()[None, :, None] * xv
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    out = _gated_out(p, y, z)
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return out, state
