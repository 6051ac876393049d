"""Shared model-building utilities.  Port of ``repro.models.common``.

Parameters live in nested dicts of tensors.  Every module defines its
structure once through a :class:`Builder`, which runs in four modes:

* ``init``  - draw parameter values from an explicit ``torch.Generator``,
* ``axes``  - emit the matching tree of logical axis strings,
* ``shape`` - emit the matching tree of shapes (no allocation),
* ``spec``  - emit the matching tree of :class:`ParamSpec` (what ``init``
  would draw, drawn later leaf by leaf or layer by layer: a model whose
  f32 tree does not fit the device at once),

so values, axis metadata and artifact templates cannot drift apart.
Compute runs in bf16 over f32 parameters, as in the reference.

Under rules (tensor parallelism) a dense leaf the mesh shards is this
rank's ``dist.sharding.DenseBlock``: :func:`dense` and
:func:`expert_dense` sum its K-partials or gather its columns
(``kernels.shard.dense_sharded``), :func:`embed_lookup` looks ids up in
the rank's vocab block and sums the blocks exactly
(``kernels.shard.lookup_sharded``), :func:`unembed` multiplies by the
block and sums or gathers, and the MoE router is gathered whole where it
is used; each rank stores only its block.  Under
``kernels.shard.whole_weights`` (calibration) each of them gathers the
leaf's bf16 cast whole where it is used (the bits one process computes
with) and computes as one process does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import DenseBlock
from repro_torch.sparse.formats import SparseTensor

PyTree = Any
COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter as ``init`` mode draws it: its full shape (stacked
    axes first), ``zeros``, ``ones``, a truncated normal on [-2, 2] times
    ``scale`` (``normal``) or a uniform draw on [-1, 1) times ``scale``
    (``uniform``: Mamba2's ``A_log``), stored as ``dtype``."""
    shape: tuple[int, ...]
    init: str
    scale: float | None
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def draw(self, generator: torch.Generator | None, device=None, *,
             index: tuple[int, ...] = ()) -> torch.Tensor:
        """The values (``index`` selects a slice of the leading axes, one
        layer of a stacked leaf, drawn alone)."""
        shape = self.shape[len(index):]
        if self.init in ("zeros", "ones"):
            fill = torch.zeros if self.init == "zeros" else torch.ones
            return fill(shape, dtype=self.dtype, device=device)
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if self.init == "uniform":
            t.uniform_(-1.0, 1.0, generator=generator)
        else:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        return (t * self.scale).to(self.dtype)


class Builder:
    """Single-definition parameter structure builder.

    ``lead`` prepends stacked axes (a stage's "layers" axis): a stacked
    parameter is drawn whole, with the fan-in of one layer's shape.
    """

    def __init__(self, mode: str, generator: torch.Generator | None = None,
                 device: torch.device | None = None, lead: tuple = ()):
        if mode not in ("init", "axes", "shape", "spec"):
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
        if init not in ("zeros", "ones", "normal", "uniform"):
            raise ValueError(init)
        if init == "normal" and scale is None:  # fan-in scaling
            scale = (shape[0] if len(shape) > 1 else shape[-1]) ** -0.5
        if init == "uniform" and scale is None:
            scale = 1.0
        spec = ParamSpec(full, init, scale, dtype)
        if self.mode == "spec":
            return spec
        return spec.draw(self.generator, self.device)


def dense_init(b: Builder, d_in: int, d_out: int,
               axes: tuple[str | None, str | None], *,
               scale: float | None = None) -> PyTree:
    return {"kernel": b.param((d_in, d_out), axes, scale=scale)}


def dense(params: PyTree, x: torch.Tensor, *,
          tape_x: torch.Tensor | None = None) -> torch.Tensor:
    """x @ kernel (the kernel rounded to bf16; an f32 x promotes it back
    to f32, as JAX's type promotion does).  While a stats tape records
    (the calibration stats pass), the tape sees x, or ``tape_x`` where the
    caller has the input before its rounding to x.dtype."""
    k = params["kernel"]
    if isinstance(k, SparseTensor):
        # 2:4-compressed kernel: the hand-written nm_matmul
        from repro_torch.sparse import apply as sparse_apply
        return sparse_apply.sparse_dense(k, x)
    from repro_torch.core import tape as _tape
    t = _tape.current_tape()
    if t is not None:   # under rules (a DenseBlock), x is whole too
        t.record(k, x if tape_x is None else tape_x)
    if isinstance(k, DenseBlock):
        from repro_torch.kernels import shard as ksh
        if not ksh.weights_whole():
            return ksh.dense_sharded(k.to(COMPUTE_DTYPE), x)
        k = ksh.gathered(k.to(COMPUTE_DTYPE))
    return x @ k.to(COMPUTE_DTYPE).to(torch.promote_types(COMPUTE_DTYPE,
                                                          x.dtype))


def kernel_dense(params: PyTree) -> torch.Tensor:
    """Dense view of a (possibly compressed) kernel leaf, for the call sites
    that read weights directly (the MLA absorbed decode's ``w_uk`` and
    ``w_uv``): a ``SparseTensor`` decompressed on its device (tensor ops
    only, so a CUDA graph captures it), a dense kernel as it is."""
    k = params["kernel"]
    return k.to_dense() if isinstance(k, SparseTensor) else k


def expert_dense(params: PyTree, buf: torch.Tensor) -> torch.Tensor:
    """Expert-banked FFN matmul: MoE dispatch buffer (G, E, C, d_in) against
    an (E, d_in, d_out) kernel -> (G, E, C, d_out).

    Compressed banks run the hand-written ``nm_matmul_expert``; dense banks
    one ``torch.bmm`` over the same per-expert rows, the op the kernel's
    plain version runs, so masked-dense and compressed serving agree bit for
    bit on the CPU.
    """
    from repro_torch.sparse import apply as sparse_apply
    k = params["kernel"]
    if isinstance(k, SparseTensor):
        return sparse_apply.sparse_moe_dense(k, buf)
    x3 = sparse_apply.per_expert(buf)
    if isinstance(k, DenseBlock):
        from repro_torch.kernels import shard as ksh
        y = (torch.bmm(x3, ksh.gathered(k.to(COMPUTE_DTYPE)))
             if ksh.weights_whole() else
             ksh.dense_sharded(k.to(COMPUTE_DTYPE), x3, expert=True))
    else:
        y = torch.bmm(x3, k.to(COMPUTE_DTYPE))
    return sparse_apply.from_per_expert(y, buf.shape[0])


def expert_dense_pair(p_up: PyTree, p_gate: PyTree, buf: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Up + gate expert banks over one dispatch buffer.  Compressed banks
    with matching K-shard tags run as one pair with one all-reduce
    (``sparse.apply.sparse_moe_dense2``); otherwise two
    :func:`expert_dense` calls, as the reference's."""
    ku, kg = p_up["kernel"], p_gate["kernel"]
    if isinstance(ku, SparseTensor) and isinstance(kg, SparseTensor):
        from repro_torch.kernels.shard import pair_k_sharded
        if pair_k_sharded(ku, kg):
            from repro_torch.sparse import apply as sparse_apply
            return sparse_apply.sparse_moe_dense2(ku, kg, buf)
    return expert_dense(p_up, buf), expert_dense(p_gate, buf)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1 + torch.exp(-x))


class _Silu(torch.autograd.Function):
    """silu whose backward is ``jax.grad``'s rule for ``x * logistic(x)``:
    e = logistic(x), then g * e + (x * g) * (e * (1 - e)), each op rounded
    to x.dtype.  (Autograd through the forward's ops would differentiate
    ``reciprocal(1 + exp(-x))`` instead, with other bf16 roundings.)"""

    @staticmethod
    def forward(ctx, x):
        e = _logistic(x)
        ctx.save_for_backward(x, e)
        return x * e

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        return g * e + (x * g) * (e * (1 - e))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x * logistic(x)``
    with ``logistic(x) = 1 / (1 + exp(-x))``, each op rounded to x.dtype.
    ``F.silu`` rounds once, and so differs from the reference in a third
    of bf16 inputs by an ulp.  Under autograd the gradient is the
    reference's too (:class:`_Silu`)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Silu.apply(x)
    return x * _logistic(x)


def _rounded(v: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype``, as JAX rounds a weakly typed
    scalar to its operand's dtype.  Multiplying a tensor by it rounds the
    exact product once, as the reference's op does, and copies nothing to
    the device (a CUDA graph may capture it)."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as the compiled reference
    computes it: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))``
    with c = sqrt(2/pi), each constant and each op rounded to x.dtype
    (``F.gelu(approximate="tanh")`` rounds once, and differs in ~2% of
    bf16 inputs).  On every bf16 input of magnitude >= 1e-30 this gives
    XLA's CPU bits (below that XLA flushes denormals).  Under autograd the
    gradient is autograd's through the same ops."""
    c, a = (_rounded(v, x.dtype) for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def act(x: torch.Tensor, name: str) -> torch.Tensor:
    """The FFN activation of a config's ``act``: silu or gelu."""
    if name == "silu":
        return silu(x)
    if name == "gelu":
        return gelu(x)
    raise NotImplementedError(f"activation {name!r} is not ported yet")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap`` (the reference's ``common.softcap``; a cap
    of 0 is the identity).  The divisor is a tensor on x's device (filled
    there, so a CUDA graph may capture it): a CUDA tensor divided by a
    Python float is multiplied by its reciprocal instead.  torch's f32
    ``tanh`` and XLA's CPU one (its own rational approximation) differ in
    the last places: within 5 f32 ulps."""
    if not cap:
        return x
    c = torch.full((), cap, dtype=x.dtype, device=x.device)
    return torch.tanh(x / c) * _rounded(cap, x.dtype)


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


def layernorm_init(b: Builder, dim: int) -> PyTree:
    return {"scale": b.param((dim,), ("embed_act",), init="zeros"),
            "bias": b.param((dim,), ("embed_act",), init="zeros")}


def layernorm(params: PyTree, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32: the mean, then the variance
    as ``jnp.var`` takes it (the mean of the squared deviations), then
    ``(1 + scale)`` and ``bias`` (zeros-init is the identity), cast back
    to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"]) + params["bias"]).to(dt)


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


def sinusoidal_positions(num: int, dim: int) -> np.ndarray:
    """Whisper's encoder positions (num, dim) f32: sin on the even
    columns, cos on the odd ones; the reference's numpy, so the same
    bits."""
    pos = np.arange(num)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((num, dim), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


def embed_init(b: Builder, vocab: int, dim: int) -> PyTree:
    return {"table": b.param((vocab, dim), ("vocab", "embed"), scale=1.0)}


def embed_lookup(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    t = params["table"]
    if isinstance(t, DenseBlock):
        from repro_torch.kernels import shard as ksh
        if not ksh.weights_whole():
            return ksh.lookup_sharded(t, tokens, COMPUTE_DTYPE)
        t = ksh.gathered(t.to(COMPUTE_DTYPE))
    return t.to(COMPUTE_DTYPE)[tokens]


def scale_embed(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """gemma's ``x * sqrt(d_model)`` on the bf16 embeddings: JAX rounds
    the weakly typed scalar to x's dtype first, then the product."""
    return x * _rounded(math.sqrt(d_model), x.dtype)


def unembed(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ table.T -> logits (fp32, rounded through the
    compute dtype as in the reference)."""
    t = params["table"]
    if isinstance(t, DenseBlock):
        from repro_torch.kernels import shard as ksh
        if not ksh.weights_whole():
            return ksh.dense_sharded(DenseBlock(t.data.T, t.spec[::-1])
                                     .to(COMPUTE_DTYPE), x).float()
        t = ksh.gathered(t.to(COMPUTE_DTYPE))
    return (x @ t.to(COMPUTE_DTYPE).T).float()
