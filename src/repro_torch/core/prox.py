"""Proximal operators.  Port of ``repro.core.prox``.

* ``soft_threshold`` - prox of lam*||.||_1 (the paper's Omega on Gamma).
* ``prox_nm24``      - prox of the 2:4-inducing regularizer
  R(w) = |w1||w2||w3| + |w2||w3||w4| + |w3||w4||w1| + |w4||w1||w2| on each
  contiguous group of 4 along the input dim: a damped Jacobi fixed point
      u_i = max(0, |w_i| - lam * sum_{pairs (j,k) != i} u_j u_k),
  signs restored afterwards.  It is the plain version of the hand-written
  ``kernels.nm_prox.prox24``, which the search runs on the card.

The arithmetic is the reference's, op for op in f32 (each product, sum and
the damping rounded as ``jnp`` rounds them), so the results are
bit-identical to it.  ``sign(w) * u`` is written ``copysign(u, w)``: the
two agree for u >= 0, signed zeros included (``torch.sign(-0.0)`` is
+0.0 where ``jnp.sign`` keeps -0.0).
"""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, lam: float) -> torch.Tensor:
    return torch.copysign(torch.clamp_min(v.abs() - lam, 0.0), v)


# for entry i of a group, dR/du_i = a*b + b*c + c*a over the other three,
# in _pairsum_others's term order: (a, b, c) = (A[i], B[i], C[i])
_A, _B, _C = [1, 0, 0, 0], [2, 2, 1, 1], [3, 3, 3, 2]


def prox_nm24(w: torch.Tensor, lam: float, *, iters: int = 12,
              damping: float = 0.7) -> torch.Tensor:
    """Prox of lam*R_{2:4} on groups of 4 along the second-to-last dim.

    w: (*lead, d_in, d_out) with d_in % 4 == 0.  Groups are contiguous along
    d_in (the GEMM reduction dim, the 2:4 hardware layout).  Returns the
    input's dtype.
    """
    *lead, d_in, d_out = w.shape
    if d_in % 4:
        raise ValueError(f"prox_nm24: d_in={d_in} is not a multiple of 4")
    g = w.float().reshape(*lead, d_in // 4, 4, d_out)
    absw = g.abs()
    keep = 1 - damping                 # rounded to f32 as the reference does
    u = absw
    for _ in range(iters):
        a, b, c = (torch.cat([u[..., i:i + 1, :] for i in idx], dim=-2)
                   for idx in (_A, _B, _C))
        e = a * b + b * c + c * a
        u = damping * torch.clamp_min(absw - lam * e, 0.0) + keep * u
    return torch.copysign(u, g).reshape(w.shape).to(w.dtype)
