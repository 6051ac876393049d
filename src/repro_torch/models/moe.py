"""Mixture-of-Experts FFN with scatter-based token dispatch.

Port of ``repro.models.moe``.  Dispatch is group-local: the tokens are
viewed as G groups of T/G, with G the product of the installed rules'
"batch" axes (``_dp_setup``; 1 without rules, or when T/G would be under
8 or uneven), and each group fills its own expert capacity, as the
reference's; the port's activations stay replicated, so every rank
dispatches every group.  Tokens route to their top-k experts by an f32 softmax
router; each expert takes at most C tokens (``capacity_factor``), placed by
a cumulative count over the token order, and the overflow is dropped.  The
dispatch buffer (G, E, C, d) runs through ``common.expert_dense_pair`` and
``common.expert_dense``: compressed SparseTensor banks through the
hand-written ``nm_matmul_expert``, dense banks through one batched matmul.
The combine gathers each assignment's row back (0 for a dropped one),
weights it by its renormalised gate and sums over the k choices; shared
experts (deepseek), one gated MLP over every token, add to it.  While a
stats tape records, the expert banks' inputs go to it with each expert's
routed-row count (the reference's hook), and the shared MLP's through
``common.dense``, as every dense projection's.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tape as _tape
from repro_torch.dist.axes import current_rules
from repro_torch.dist.sharding import DenseBlock
from repro_torch.models import common as cm
from repro_torch.models.common import Builder
from repro_torch.models.mlp import mlp_apply, mlp_init

PyTree = Any


def moe_init(b: Builder, *, d_model: int, d_ff: int, num_experts: int,
             num_shared: int = 0, expert_sharded: bool = False) -> PyTree:
    """Router (d_model, E) and the up, gate and down expert banks; with
    ``num_shared`` > 0 also ``shared``, one gated MLP of width
    num_shared * d_ff that every token takes (deepseek's shared experts)."""
    e_ax = "experts" if expert_sharded else None
    f_ax = None if expert_sharded else "mlp"
    p = {
        "router": {"kernel": b.param((d_model, num_experts), ("embed", None),
                                     scale=d_model ** -0.5)},
        "up": {"kernel": b.param((num_experts, d_model, d_ff),
                                 (e_ax, "embed", f_ax))},
        "gate": {"kernel": b.param((num_experts, d_model, d_ff),
                                   (e_ax, "embed", f_ax))},
        "down": {"kernel": b.param((num_experts, d_ff, d_model),
                                   (e_ax, f_ax, "embed"))},
    }
    if num_shared:
        p["shared"] = mlp_init(b, d_model, num_shared * d_ff)
    return p


def _dp_setup() -> int:
    """Dispatch groups from the installed rules: the product of the mesh
    sizes of the "batch" rule's axes (1 without rules)."""
    rules = current_rules()
    if rules is None:
        return 1
    batch_axes = rules.rules.get("batch") or ()
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    n = 1
    for a in batch_axes:
        if a in rules.mesh.axis_names:
            n *= rules.mesh.shape[a]
    return n


def capacity(tokens: int, top_k: int, num_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Rows per expert: the reference's C, a multiple of 8 (at least 8),
    capped at the token count."""
    C = int(capacity_factor * tokens * top_k / num_experts)
    return min(max(8, -(-C // 8) * 8), tokens)


def _one_hot(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Boolean one-hot by comparison (``F.one_hot`` may check its input's
    range on the host, a sync that a CUDA graph cannot capture)."""
    return ids[..., None] == torch.arange(E, device=ids.device)


def _positions_in_expert(flat_e: torch.Tensor, E: int, C: int):
    """flat_e: (..., A) expert ids -> (e_idx, p_idx, keep, onehot).

    An assignment's position is the number of earlier assignments to its
    expert; positions at or past C are dropped (e_idx = E, out of range).
    """
    oh = _one_hot(flat_e, E).to(torch.int32)
    pos_all = torch.cumsum(oh, dim=-2) - oh
    pos = torch.gather(pos_all, -1, flat_e[..., None])[..., 0]
    keep = pos < C
    e_idx = torch.where(keep, flat_e, E)
    p_idx = torch.where(keep, pos, 0)
    return e_idx, p_idx, keep, oh


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, descending, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: PyTree, x: torch.Tensor, top_k: int):
    """(probs (..., E), renormalised top-k gates (..., k), expert ids
    (..., k)) from f32 router logits, as the reference computes them."""
    k = router["kernel"]
    if isinstance(k, DenseBlock):       # small: gathered whole, exact
        from repro_torch.kernels.shard import gathered
        k = gathered(k)
    probs = torch.softmax(x.float() @ k.float(), dim=-1)
    gate_vals, idx = _top_k(probs, top_k)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), idx


def moe_apply(p: PyTree, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux load-balance loss).  x: (..., d)."""
    orig_shape = x.shape
    d = x.shape[-1]
    T = x.numel() // d
    G = _dp_setup()
    if T % G or T // G < 8:
        G = 1
    Tl = T // G
    xg = x.reshape(G, Tl, d)
    E = p["router"]["kernel"].shape[-1]
    probs, gate_vals, idx = route(p["router"], xg, top_k)

    C = capacity(Tl, top_k, E, capacity_factor)
    flat_e = idx.reshape(G, Tl * top_k)   # expert id per assignment
    e_idx, p_idx, keep, _ = _positions_in_expert(flat_e, E, C)
    src = torch.repeat_interleave(xg, top_k, dim=1)         # (G, Tl*k, d)
    g_iota = torch.arange(G, device=x.device)[:, None].expand(e_idx.shape)
    # scatter every assignment, the dropped ones onto one spare row past
    # the buffer: no boolean indexing, so no host sync (the decode step
    # stays capturable in a CUDA graph); kept (expert, position) pairs are
    # unique, so their rows are written once
    rows = torch.where(keep, (g_iota * E + e_idx) * C + p_idx, G * E * C)
    flat = torch.zeros((G * E * C + 1, d), dtype=x.dtype, device=x.device)
    flat.index_put_((rows.reshape(-1),), src.reshape(-1, d))
    buf = flat[:-1].view(G, E, C, d)

    t = _tape.current_tape()
    if t is not None:   # per-(expert, input-feature) activation stats
        # The capacity buffer is zero-padded (unfilled slots, dropped
        # tokens): zeros add nothing to the sum of squares, but an
        # expert's sample size is its routed-row count, not G*C, so the
        # tape rescales its sums to the T tokens a dense FFN sees.
        routed = _one_hot(e_idx, E).sum(dim=(0, 1))
        t.record(p["up"]["kernel"], buf.transpose(0, 1), count=routed,
                 ref_count=T)
        t.record(p["gate"]["kernel"], buf.transpose(0, 1), count=routed,
                 ref_count=T)

    h, g = cm.expert_dense_pair(p["up"], p["gate"], buf)
    h = h * cm.act(g, act)
    if t is not None:
        t.record(p["down"]["kernel"], h.transpose(0, 1), count=routed,
                 ref_count=T)
    out_buf = cm.expert_dense(p["down"], h)

    y_tk = out_buf[g_iota, e_idx.clamp(max=E - 1), p_idx]   # (G, Tl*k, d)
    y_tk = torch.where(keep[..., None], y_tk, 0)            # dropped -> 0
    y_tk = y_tk * gate_vals.reshape(G, -1)[..., None].to(y_tk.dtype)
    y = y_tk.reshape(G, Tl, top_k, d).sum(dim=2).reshape(orig_shape)
    if "shared" in p:       # every token, through the plain dense path
        y = y + mlp_apply(p["shared"], x, act=act)

    # Switch-style load-balance aux loss: E * sum_e f_e * P_e
    oh = _one_hot(flat_e, E).float()
    frac = oh.mean(dim=(0, 1)) * E
    mean_prob = probs.mean(dim=(0, 1)) * E
    return y, (frac * mean_prob).mean()
