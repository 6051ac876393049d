"""JAX's threefry-2x32 random stream in torch integer arithmetic.

The port's own copy of what the search draws from ``jax.random`` (jax
0.9.0, ``jax_threefry_partitionable = True``, its default): the
threefry-2x32 hash (``jax._src.prng.threefry_2x32``), the seed, ``fold_in``
and ``split`` on keys, ``random_bits`` and the f32 ``uniform`` and
``bernoulli`` draws (``jax._src.random``).  Every function gives the words
jax gives, bit for bit.

For the serve launcher's ``--temperature`` it also gives the narrower
``random_bits`` widths, the bf16 and f16 ``uniform`` and ``gumbel`` and
``categorical`` (mode 'low').

A key is the pair of uint32 words that ``jax.random.key_data`` gives,
``(hi, lo)``, held as two Python ints.  Keys are derived on the host (a
hash of one or two words); the draws are computed on the device that asks
for them, in int64 tensors masked to 32 bits, so the card and the CPU draw
the same bits.
"""
from __future__ import annotations

import torch

Key = tuple[int, int]
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash of the count words (x1, x2) under the key
    words (k1, k2): 20 rounds, a key injection every 4.  x1, x2: int64
    tensors of uint32 values; returns two such tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1.add_(x2).bitwise_and_(_M32)
            x2 = (x2 << r).bitwise_and_(_M32).bitwise_or_(x2 >> (32 - r))
            x2 = x2.bitwise_xor_(x1)
        x1 = x1.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x2 = x2.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x1, x2


def _hash_words(key: Key, hi: list[int], lo: list[int]) -> list[Key]:
    """threefry_2x32 of a few counts on the host, as (bits1, bits2)
    pairs."""
    b1, b2 = threefry_2x32(*key, torch.tensor(hi, dtype=torch.int64),
                           torch.tensor(lo, dtype=torch.int64))
    return list(zip(b1.tolist(), b2.tolist()))


def threefry_seed(seed: int) -> Key:
    """jax's ``threefry_seed`` of a 64-bit integer seed: its high and low
    32 bits."""
    if not -2 ** 63 <= seed < 2 ** 64:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    return (seed >> 32) & _M32, seed & _M32


def key(seed: int) -> Key:
    """``jax.random.key_data(jax.random.key(seed))`` under jax's default
    32-bit mode, which the reference runs: the seed is wrapped to 32 bits
    before ``threefry_seed``, so the high word is 0."""
    return threefry_seed(seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the count pair (0, data)."""
    return _hash_words(key, [0], [data & _M32])[0]


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split`` (partitionable): key i is the hash of the
    64-bit count i."""
    return _hash_words(key, [0] * num, list(range(num)))


def random_bits(key: Key, shape: tuple[int, ...], device=None, *,
                width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` 8, 16 or 32 (partitionable): the
    hash of the 64-bit row-major index of every element, its two words
    xor-ed, and cut to the low ``width`` bits as jax's conversion to the
    narrower unsigned type cuts them.  An int64 tensor of those unsigned
    values on ``device``."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits: width {width} is not 8, 16 or 32")
    idx = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                       device=device)
    b1, b2 = threefry_2x32(*key, idx >> 32, idx & _M32)
    bits = b1.bitwise_xor_(b2)
    if width < 32:
        bits = bits.bitwise_and_((1 << width) - 1)
    return bits.reshape(shape)


# (bits, mantissa bits, bit pattern of 1.0, same-width int type) of each
# float type ``uniform`` draws, as jax's ``finfo``
_FLOATS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
           torch.bfloat16: (16, 7, 0x3F80, torch.int16),
           torch.float16: (16, 10, 0x3C00, torch.int16)}


def uniform(key: Key, shape: tuple[int, ...], device=None, *,
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` on [minval, maxval) in f32, bf16 or f16:
    random mantissa bits under the exponent of 1.0, minus 1, scaled and
    shifted in ``dtype``.  Types of fewer than 8 mantissa bits (bf16) draw
    8-bit words, as jax does."""
    nbits, nmant, one, itype = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, device, width=rng_bits)
    bits = (bits >> (rng_bits - nmant)) | one
    floats = bits.to(itype).view(dtype) - torch.ones((), dtype=dtype,
                                                     device=bits.device)
    lo = torch.full((), minval, dtype=dtype, device=bits.device)
    hi = torch.full((), maxval, dtype=dtype, device=bits.device)
    if dtype == torch.bfloat16:   # each op rounds to bf16, as jax's
        scaled = floats * (hi - lo) + lo
    else:
        # f32 and f16: floats * (hi - lo) + lo rounded once, as the jitted
        # reference's fused multiply-add; the product is exact in f64, so
        # one f64 sum rounded to dtype gives the same value (a double
        # rounding could differ only at a tie of dtype, which an f64 sum of
        # these operands all but never hits)
        scaled = (floats.double() * (hi - lo).double()
                  + lo.double()).to(dtype)
    return torch.maximum(lo, scaled)


def bernoulli(key: Key, p: float, shape: tuple[int, ...], device=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low'): ``uniform < p`` with p in
    f32.  A bool tensor on ``device``."""
    u = uniform(key, shape, device)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


def _log(x: torch.Tensor) -> torch.Tensor:
    """log, rounded once to x.dtype: computed in f64 on any device, so the
    card and the CPU give the same bits."""
    return torch.log(x.double()).to(x.dtype)


def gumbel(key: Key, shape: tuple[int, ...], device=None, *,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode 'low'): -log(-log(u)), u uniform on
    [finfo.tiny, 1) in ``dtype``, each log rounded to ``dtype``.  Equal to
    jax's bit for bit in bf16; in f32 XLA's CPU log is not correctly
    rounded, so a draw may differ from jax's in its last place."""
    u = uniform(key, shape, device, dtype=dtype,
                minval=torch.finfo(dtype).tiny, maxval=1.0)
    return -_log(-_log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (with replacement):
    argmax of gumbel noise in the logits' dtype plus the logits."""
    g = gumbel(key, tuple(logits.shape), logits.device, dtype=logits.dtype)
    return torch.argmax(g + logits, dim=-1)
