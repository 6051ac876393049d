"""Plain PyTorch versions of the ported kernels.

The CPU path of every kernel wrapper, and what ``chip_smoke.py`` holds each
CUDA kernel against on the card.  They repeat ``repro.kernels.ref`` (and
the materialised oracles beside the flash-decode kernels) op for op, so on
the CPU they agree with the JAX package exactly on integer outputs.
"""
from __future__ import annotations

import torch


# --- nm_spmm ---------------------------------------------------------------

def compress_24(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (K, N) (assumed or forced 2:4 along K) -> (vals, idx).

    Keeps the top-2 |w| per contiguous group of 4 along K, positions
    ascending.  The sort is stable, as ``jnp.argsort`` is, so ties keep the
    reference's choice.
    """
    K, N = w.shape
    if K % 4:
        raise ValueError(f"K={K} is not a multiple of 4")
    g = w.reshape(K // 4, 4, N)
    order = torch.argsort(-g.abs(), dim=1, stable=True)[:, :2]
    idx = torch.sort(order, dim=1).values
    vals = torch.gather(g, 1, idx)
    return vals.reshape(K // 2, N), idx.to(torch.int8).reshape(K // 2, N)


def decompress_24(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) vals + int8 positions -> dense (..., K, N), zeros
    elsewhere.  Leading dims (experts, layers) pass through."""
    *lead, half_k, N = vals.shape
    g = half_k // 2
    v = vals.reshape(*lead, g, 2, N)
    p = idx.reshape(*lead, g, 2, N).long()
    r = torch.arange(4, device=vals.device)[:, None]
    dense = torch.zeros((*lead, g, 4, N), dtype=vals.dtype,
                        device=vals.device)
    for j in range(2):
        dense = dense + torch.where(p[..., j:j + 1, :] == r,
                                    v[..., j:j + 1, :], 0)
    return dense.reshape(*lead, g * 4, N)


def nm_matmul_ref(x: torch.Tensor, vals: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    w = decompress_24(vals, idx)
    return (x @ w.to(x.dtype)).to(x.dtype)


# --- saliency_fuse ---------------------------------------------------------

def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as ``jnp.sqrt`` and CUDA's
    ``sqrtf`` give it.  torch's vectorised CPU ``sqrt`` is off by an ulp in
    about 0.5% of f32 inputs; the f64 root rounded to f32 is exact."""
    return torch.sqrt(x.double()).float()


def saliency_step_ref(w, a, gamma, v, *, v_lr: float, lam: float,
                      rowsum=None, colsum=None, s_div=None):
    """One fused local-metric + dual + prox step (f32 math).

    w, gamma, v: (..., K, N); a: (..., K) input-feature norms, or None for
    magnitude; rowsum (..., K, 1) and colsum (..., 1, N) for the RIA family.

    S = |w| * a[..., None]                        (wanda; a = ||X_j||_2)
    or S = |w|                                    (magnitude; a is None)
    or, when rowsum/colsum are given (RIA family):
    S = (|w|/rowsum + |w|/colsum) * sqrt(a)[..., None]
    then S = S / s_div when the search normalises the scores (s_div is the
    device scalar med + 1e-12 of ``normalize_scores``).
    V' = v - v_lr * (gamma - S);  Gamma' = soft(V', lam).
    """
    wf = w.float().abs()
    if rowsum is not None:
        af = a.float()
        s = (wf / (rowsum.float() + 1e-12) + wf / (colsum.float() + 1e-12)) \
            * sqrt_f32(torch.clamp_min(af, 1e-12))[..., None]
    elif a is not None:
        s = wf * a.float()[..., None]
    else:
        s = wf
    if s_div is not None:
        s = s / s_div
    v_new = v.float() - v_lr * (gamma.float() - s)
    gamma_new = torch.copysign(torch.clamp_min(v_new.abs() - lam, 0.0), v_new)
    return v_new, gamma_new


# --- nm mask ---------------------------------------------------------------

def nm_mask_ref(s: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """Top-n |s| per contiguous group of m along axis 0 (ties -> lower index).

    Rank-based: element i is kept iff fewer than n elements beat it, where
    "beats" = strictly greater, or equal with a lower position.
    """
    K, N = s.shape
    g = s.float().abs().reshape(K // m, m, N)
    gi = g[:, :, None, :]
    gj = g[:, None, :, :]
    pos = torch.arange(m, device=s.device)
    j_earlier = pos[None, None, :, None] < pos[None, :, None, None]
    rank = ((gj > gi) | ((gj == gi) & j_earlier)).sum(dim=2)
    return (rank < n).reshape(K, N)


def prox24_ref(w: torch.Tensor, lam: float, *, iters: int = 12,
               damping: float = 0.7) -> torch.Tensor:
    """The plain version of the ``prox24`` kernel: ``core.prox.prox_nm24``
    on a 2-D (K, N) input, as the reference's oracle is."""
    from repro_torch.core.prox import prox_nm24
    return prox_nm24(w, lam, iters=iters, damping=damping)


# --- flash_decode ----------------------------------------------------------

NEG_INF = -1e30     # the additive mask of an invalid slot


def _decode_scores(q, k, bias, scale):
    """(B,K,G,D) x (B,C,K,D) -> f32 (B,K,G,C): (q . k) * scale + bias."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bkgd,bckd->bkgc", q.float(), k.float()) * scale
    return s + bias[:, None, None, :]


def flash_decode_ref(q, k, v, bias, *, scale=None):
    """The materialised oracle of the ``flash_decode`` kernel
    (``flash_decode.py:91 flash_decode_ref``): softmax over the whole
    capacity in f32, f32 probabilities into PV.

    q (B,K,G,D); k/v (B,C,K,D|Dv); bias (B,C) f32, 0 or -1e30 per slot ->
    (B,K,G,Dv) in q's dtype."""
    p = torch.softmax(_decode_scores(q, k, bias, scale), dim=-1)
    return torch.einsum("bkgc,bckd->bkgd", p, v.float()).to(q.dtype)


def flash_decode_partial_ref(q, k, v, bias, *, scale=None):
    """The materialised (acc, m, l) oracle of ``flash_decode_partial``
    (``flash_decode.py:183``), f32: m = max(max_c s_c, -1e30) (B,K,G,1),
    l = sum_c exp(s_c - m) (B,K,G,1), acc = sum_c exp(s_c - m) v_c
    (B,K,G,Dv).  An all-masked capacity gives m = -1e30, l = C and
    acc = sum_c v_c."""
    s = _decode_scores(q, k, bias, scale)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.exp(s - m)
    acc = torch.einsum("bkgc,bckd->bkgd", p, v.float())
    return acc, m, p.sum(dim=-1, keepdim=True)


def flash_decode_shards_ref(q, k, v, bias, *, scale=None, shards: int = 1):
    """:func:`flash_decode_partial_ref` on each of ``shards`` equal
    capacity slices [s C/S, (s+1) C/S), stacked on a leading shard axis:
    acc (S,B,K,G,Dv), m and l (S,B,K,G,1)."""
    n = k.shape[1] // shards
    parts = [flash_decode_partial_ref(q, k[:, i * n:(i + 1) * n],
                                      v[:, i * n:(i + 1) * n],
                                      bias[:, i * n:(i + 1) * n],
                                      scale=scale)
             for i in range(shards)]
    return tuple(torch.stack(x) for x in zip(*parts))


def combine_partials_ref(acc, m, l, out_dtype):
    """The cross-shard combine of ``repro/kernels/shard.py:327-330``: the
    global max mg over shards (the pmax), corr = exp(m - mg), (l, acc)
    rescaled and summed over shards in shard order 0..S-1 (the psum), then
    acc / max(l, 1e-30) in ``out_dtype``.  An all-masked shard (m = -1e30)
    gets corr = 0 against any shard with a valid slot.

    acc (S,B,K,G,Dv), m and l (S,B,K,G,1), f32 -> (B,K,G,Dv)."""
    mg = m.amax(dim=0)
    l_tot = acc_tot = None
    for i in range(m.shape[0]):
        corr = torch.exp(m[i] - mg)
        li, ai = l[i] * corr, acc[i] * corr
        l_tot = li if l_tot is None else l_tot + li
        acc_tot = ai if acc_tot is None else acc_tot + ai
    return (acc_tot / torch.clamp_min(l_tot, 1e-30)).to(out_dtype)


def merge_partials_ref(acc, m, l):
    """The raw merge of P softmax states of consecutive slot ranges into
    the state of their union, as the decode kernel's cluster merges its
    splits: mg = the max of m over the leading axis, corr = exp(m - mg),
    (l, acc) rescaled and summed in order 0..P-1; no normalisation.  An
    all-masked union (every m = -1e30) keeps m = -1e30 and l = the sum of
    the slot counts, exactly.

    acc (P,...,Dv), m and l (P,...,1), f32 -> acc (...,Dv), m, l (...,1)."""
    mg = m.amax(dim=0)
    l_tot = acc_tot = None
    for i in range(m.shape[0]):
        corr = torch.exp(m[i] - mg)
        li, ai = l[i] * corr, acc[i] * corr
        l_tot = li if l_tot is None else l_tot + li
        acc_tot = ai if acc_tot is None else acc_tot + ai
    return acc_tot, mg, l_tot
