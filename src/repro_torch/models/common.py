"""Shared model-building utilities.  Port of ``repro.models.common``.

Parameters live in nested dicts of tensors.  Every module defines its
structure once through a :class:`Builder`, which runs in three modes:

* ``init``  - draw parameter values from an explicit ``torch.Generator``,
* ``axes``  - emit the matching tree of logical axis strings,
* ``shape`` - emit the matching tree of shapes (no allocation),

so values, axis metadata and artifact templates cannot drift apart.
Compute runs in bf16 over f32 parameters, as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.sparse.formats import SparseTensor

PyTree = Any
COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


class Builder:
    """Single-definition parameter structure builder.

    ``lead`` prepends stacked axes (a stage's "layers" axis): a stacked
    parameter is drawn whole, with the fan-in of one layer's shape.
    """

    def __init__(self, mode: str, generator: torch.Generator | None = None,
                 device: torch.device | None = None, lead: tuple = ()):
        if mode not in ("init", "axes", "shape"):
            raise ValueError(mode)
        if mode == "init" and generator is None:
            raise ValueError("init mode needs a torch.Generator")
        self.mode = mode
        self.generator = generator
        self.device = device
        self.lead = tuple(lead)

    def stacked(self, repeats: int) -> "Builder":
        return Builder(self.mode, self.generator, self.device,
                       (*self.lead, repeats))

    def param(self, shape: tuple[int, ...], axes: tuple[str | None, ...], *,
              init: str = "normal", scale: float | None = None,
              dtype: torch.dtype = PARAM_DTYPE):
        if len(shape) != len(axes):
            raise ValueError((shape, axes))
        full = (*self.lead, *shape)
        if self.mode == "axes":
            return "|".join(("layers",) * len(self.lead)
                            + tuple(a or "" for a in axes))
        if self.mode == "shape":
            return full
        if init == "zeros":
            return torch.zeros(full, dtype=dtype, device=self.device)
        if init == "normal":
            if scale is None:  # fan-in scaling
                scale = (shape[0] if len(shape) > 1 else shape[-1]) ** -0.5
            t = torch.empty(full, dtype=torch.float32, device=self.device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.generator)
            return (t * scale).to(dtype)
        raise ValueError(init)


def dense_init(b: Builder, d_in: int, d_out: int,
               axes: tuple[str | None, str | None], *,
               scale: float | None = None) -> PyTree:
    return {"kernel": b.param((d_in, d_out), axes, scale=scale)}


def dense(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    k = params["kernel"]
    if isinstance(k, SparseTensor):
        # 2:4-compressed kernel: the hand-written nm_matmul
        from repro_torch.sparse import apply as sparse_apply
        return sparse_apply.sparse_dense(k, x)
    return x @ k.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(b: Builder, dim: int) -> PyTree:
    return {"scale": b.param((dim,), ("embed_act",), init="zeros")}


def rmsnorm(params: PyTree, x: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) so zeros-init is identity
    return (x * (1.0 + params["scale"].float())).to(dt)


# ---------------------------------------------------------------------------
# Positional encodings / embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions:
    (..., seq)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq    # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_init(b: Builder, vocab: int, dim: int) -> PyTree:
    return {"table": b.param((vocab, dim), ("vocab", "embed"), scale=1.0)}


def embed_lookup(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"].to(COMPUTE_DTYPE)[tokens]


def unembed(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ table.T -> logits (fp32, rounded through the
    compute dtype as in the reference)."""
    return (x @ params["table"].to(COMPUTE_DTYPE).T).float()
