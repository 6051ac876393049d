"""What the static analysis sees of the hand-written kernels.

Every public kernel wrapper (``nm_matmul``, ``nm_matmul_expert``,
``flash_decode``, ``flash_decode_partial``, ``combine_partials``,
``saliency_fused_step``, ``prox24``, ``nm_mask24``) is wrapped by
:func:`kernel`.  With no observer installed - always, outside
``repro_torch.analysis`` - a call goes straight to the wrapper.  With one
installed (``analysis.audit``'s op recorder) the observer sees the call as
ONE op: its name, its tensor arguments and its outputs, as a launch is one
op on the card; the plain version's ops beneath it (on the CPU, or on the
``meta`` device, where they only carry shapes) stay hidden from it.

:func:`kernel_pair` marks two calls of one kernel over the same input
(the gated MLP's up and gate: ``sparse.apply.sparse_dense2``), which the
reference's CPU route runs as one call over the pair concatenated along
N and its TPU route, as the port does, as two.

:func:`f32_accumulation` marks the f32 operand copies that stand in for an
f32-accumulating product of bf16 operands (the reference's
``preferred_element_type=jnp.float32``), which a torch product of bf16
operands cannot ask for: the observer lists those upcasts as accumulators,
as the reference's audit exempts its K-partial accumulators.

A wrapper runs its plain version on the devices :func:`plain_devices`
names - the CPU, and the ``meta`` device while an observer records (its
shape rule: nothing is computed) - and launches its kernel (or raises) on
a CUDA tensor; with no observer a meta tensor raises, as any device
without a kernel does.
"""
from __future__ import annotations

import contextlib
import functools
import threading

_tls = threading.local()


def observer():
    """The installed observer, or None."""
    return getattr(_tls, "observer", None)


def plain_devices() -> tuple[str, ...]:
    """The device types whose tensors take a wrapper's plain version."""
    return ("cpu",) if getattr(_tls, "observer", None) is None \
        else ("cpu", "meta")


@contextlib.contextmanager
def observing(obs):
    """Install ``obs`` (an object with ``kernel_call(name, fn, args,
    kwargs)``, ``pair()`` and ``accumulation()``) for the duration of the
    block."""
    prev = observer()
    _tls.observer = obs
    try:
        yield obs
    finally:
        _tls.observer = prev


def kernel(name: str):
    """Decorator of a kernel wrapper: the installed observer, if any, sees
    each call as one op named ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            obs = getattr(_tls, "observer", None)
            if obs is None:
                return fn(*args, **kwargs)
            return obs.kernel_call(name, fn, args, kwargs)
        return call
    return deco


@contextlib.contextmanager
def f32_accumulation():
    """Around the f32 copies of bf16 operands that a product reads to
    accumulate in f32 (see the module docstring)."""
    obs = getattr(_tls, "observer", None)
    if obs is None:
        yield
        return
    with obs.accumulation():
        yield


@contextlib.contextmanager
def kernel_pair():
    """Around two calls of one kernel over the same input (see the module
    docstring)."""
    obs = getattr(_tls, "observer", None)
    if obs is None:
        yield
        return
    with obs.pair():
        yield
