"""repro_torch's optimizers and int8 error-feedback compression against the
JAX reference, in one process on numpy-seeded inputs.

Tolerances, and why:

* ``adamw_update`` (without clipping, or with a clip that does not bind,
  at several counts) and ``sgd_update``: params, mu, nu, count and lr bit
  for bit against the reference run op by op (``jax.disable_jit``): the
  port rounds every op in the reference's order.  With a clip that binds,
  the scale comes from the global norm below (two f32 units apart at
  most): mu and nu within 4 f32 units at the scale of the leaf's largest
  entry, params as against the jitted reference.  Jitted, XLA's CPU backend contracts multiply-adds into
  fused multiply-adds, so against the jitted reference: params within 4
  f32 units at the scale of the leaf's largest entry and within 2e-5 of
  its largest update; mu and nu within 4 f32 units at the scale of the
  leaf's largest entry (a contracted ``b * m + (1 - b) * g``).
* ``global_norm`` and ``grad_norm``: rtol 2**-22 (two f32 units: the per-leaf
  sums of squares reduce in another order).
* ``warmup_cosine``: every step of a 12-step schedule within 2 f32 units
  of the rate (``jnp.cos`` and ``torch.cos`` are different polynomials;
  the other ops are exact).
* ``clip_by_global_norm``: each leaf times a scale from that norm, within
  4 f32 units at the scale of the largest entry.
* the compression functions: bit for bit against the reference op by op
  (``ef_quantize``'s residual is a multiply-add that jitted XLA
  contracts), the int8 payload and scale bit for bit against the jitted
  reference too.
* ``compressed_allreduce`` over two ``gloo`` ranks: the mean and each
  rank's residual bit for bit against :func:`simulate_workers`.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from repro.optim import compress as jcomp
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.optim import compress as tcomp
from repro_torch.optim import optimizers as topt


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (64, 48), "b": {"c": (300,), "d": (7, 5, 9)}}


def _tree(seed, scale, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _torch(t):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _pairs(jt, tt):
    return list(zip(jax.tree.leaves(jt), tree.leaves(tt), strict=True))


def test_warmup_cosine_every_step():
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=12)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    fn = jax.jit(lambda c: jopt.warmup_cosine(jc, c))
    for s in range(15):
        want = np.float32(fn(jnp.int32(s)))
        got = topt.warmup_cosine(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), want) <= 2, (s, float(got), want)
        assert _ulps(topt.warmup_cosine(tc, s).numpy(), want) <= 2


def _close_moments(pairs):
    """Within 4 f32 units at the scale of the leaf's largest entry."""
    for a, b in pairs:
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 4 * np.spacing(np.abs(a).max())


def _close_params(want, got, p0):
    """Within 4 f32 units at the scale of the leaf's largest entry and
    within 2e-5 of its largest update."""
    for (a, b), x in zip(_pairs(want, got), jax.tree.leaves(p0)):
        a, b = np.asarray(a), b.numpy()
        err = np.abs(a - b).max()
        assert err <= 4 * np.spacing(np.abs(a).max()), err
        assert err <= 2e-5 * np.abs(a - x).max(), err


@pytest.mark.parametrize("count", [0, 1, 6])
@pytest.mark.parametrize("clip", [0.0, 1e3, 1.0])
def test_adamw_update_matches_reference(count, clip):
    """clip 0: no clipping; 1e3: clipping on but inactive (scale 1); 1.0:
    active, the scale from a global norm two f32 units apart at most."""
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=12, clip_norm=clip)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    p, g, m = _tree(0, 0.05), _tree(1, 1.0), _tree(2, 0.01)
    v = jax.tree.map(np.abs, _tree(3, 1.0))
    js = jopt.AdamWState(mu=m, nu=v, count=jnp.int32(count))
    fn = lambda g, s, p: jopt.adamw_update(jc, g, s, p)
    jit_p, jit_s, jit_m = jax.jit(fn)(g, js, p)
    with jax.disable_jit():
        ref_p, ref_s, ref_m = fn(g, js, p)
    tp = _torch(p)
    ts = topt.AdamWState(mu=_torch(m), nu=_torch(v),
                         count=torch.tensor(count, dtype=torch.int32))
    out_p, out_s, out_m = topt.adamw_update(tc, _torch(g), ts, tp)
    # in place: the same tensors, updated
    assert out_p is tp and out_s is ts
    assert out_s.count.dtype == torch.int32 and int(out_s.count) == count + 1
    assert float(out_m["lr"]) == float(ref_m["lr"])
    np.testing.assert_allclose(float(out_m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=2.0 ** -22)
    moments = _pairs(ref_s.mu, out_s.mu) + _pairs(ref_s.nu, out_s.nu)
    if clip == 1.0:
        _close_params(ref_p, out_p, p)
        _close_moments(moments)
    else:
        for a, b in _pairs(ref_p, out_p) + moments:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # against the jitted reference (contracted multiply-adds)
    _close_params(jit_p, out_p, p)
    _close_moments(_pairs(jit_s.mu, out_s.mu) + _pairs(jit_s.nu, out_s.nu))


def test_sgd_update_matches_reference():
    p, g = _tree(4, 0.05), _tree(5, 1.0)
    with jax.disable_jit():
        want = jopt.sgd_update(0.1, g, p)
    tp = _torch(p)
    got = topt.sgd_update(0.1, _torch(g), tp)
    assert got is tp
    for a, b in _pairs(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_global_norm_and_clip_match_reference():
    g = _tree(6, 1.0)
    jn = jax.jit(jopt.global_norm)(g)
    tn = topt.global_norm(_torch(g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=2.0 ** -22)
    for max_norm in (1.0, 1e3):
        jcl, jg = jax.jit(lambda t: jopt.clip_by_global_norm(t, max_norm))(g)
        tt = _torch(g)
        tcl, tg = topt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tg), float(jg), rtol=2.0 ** -22)
        for (a, b), x in zip(_pairs(jcl, tcl), tree.leaves(tt)):
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= \
                4 * np.spacing(np.abs(a).max())
            assert b is not x              # a new tree; the input untouched
        for a, b in _pairs(g, tt):
            np.testing.assert_array_equal(b.numpy(), a)


def test_adamw_init_matches_reference():
    p = _tree(7, 1.0)
    js = jopt.adamw_init(p)
    ts = topt.adamw_init(_torch(p))
    assert ts.count.dtype == torch.int32 and int(ts.count) == int(js.count)
    for a, b in _pairs(js.mu, ts.mu) + _pairs(js.nu, ts.nu):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# --- compression -------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 1e3)])
def test_quantize_and_ef_match_reference(seed, scale):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((33, 17))).astype(np.float32)
    e = (0.01 * scale * rng.standard_normal((33, 17))).astype(np.float32)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    jq, js = jax.jit(jcomp.quantize_int8)(x)
    tq, ts = tcomp.quantize_int8(tx)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts).numpy(),
        np.asarray(jax.jit(jcomp.dequantize_int8)(jq, js)))
    with jax.disable_jit():
        jq, js, je = jcomp.ef_quantize(x, e)
    tq, ts, tnew = tcomp.ef_quantize(tx, te)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(je))
    # the quantization error bound of the reference's own test
    err = np.abs(tcomp.dequantize_int8(tq, ts).numpy() - (x + e))
    assert err.max() <= float(ts) / 2 + 1e-6


def test_simulate_workers_and_wire_bytes_match_reference():
    grads = [_tree(10 + i, 1.0) for i in range(3)]
    errs = [_tree(20 + i, 0.01) for i in range(3)]
    with jax.disable_jit():
        jmean, jerrs = jcomp.simulate_workers(grads, errs)
    tmean, terrs = tcomp.simulate_workers([_torch(g) for g in grads],
                                          [_torch(e) for e in errs])
    for a, b in _pairs(jmean, tmean):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for je, te in zip(jerrs, terrs, strict=True):
        for a, b in _pairs(je, te):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    zero = tcomp.tree_ef_init(_torch(grads[0]))
    for a, b in _pairs(jcomp.tree_ef_init(grads[0]), zero):
        assert b.dtype == torch.float32 and not b.any()
        assert tuple(b.shape) == a.shape
    for compressed in (True, False):
        assert tcomp.wire_bytes(_torch(grads[0]), compressed=compressed) == \
            jcomp.wire_bytes(grads[0], compressed=compressed)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compress
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    try:
        rng = np.random.default_rng(rank)
        x = torch.from_numpy((rng.standard_normal((40, 24)) * (1 + rank))
                             .astype(np.float32))
        err = torch.from_numpy((0.01 * rng.standard_normal((40, 24)))
                               .astype(np.float32))
        mean, new_err = compress.compressed_allreduce(x, err)
        mean2, new_err2 = compress.compressed_allreduce(x, new_err)
        np.savez(out, x=x.numpy(), err=err.numpy(), mean=mean.numpy(),
                 new_err=new_err.numpy(), mean2=mean2.numpy(),
                 new_err2=new_err2.numpy())
    finally:
        dist.destroy_process_group()
""")


def test_compressed_allreduce_two_gloo_ranks(tmp_path):
    """Two processes over a ``file://`` store under tmp_path: every rank's
    mean and residual equal ``simulate_workers``' (port and reference),
    for two rounds of error feedback."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    xs = [{"w": torch.from_numpy(r["x"])} for r in res]
    errs = [{"w": torch.from_numpy(r["err"])} for r in res]
    mean, new_errs = tcomp.simulate_workers(xs, errs)
    mean2, new_errs2 = tcomp.simulate_workers(xs, new_errs)
    with jax.disable_jit():
        jmean, _ = jcomp.simulate_workers(
            [{"w": r["x"]} for r in res], [{"w": r["err"]} for r in res])
    np.testing.assert_array_equal(mean["w"].numpy(), np.asarray(jmean["w"]))
    for r, e, e2 in zip(res, new_errs, new_errs2):
        np.testing.assert_array_equal(r["mean"], mean["w"].numpy())
        np.testing.assert_array_equal(r["new_err"], e["w"].numpy())
        np.testing.assert_array_equal(r["mean2"], mean2["w"].numpy())
        np.testing.assert_array_equal(r["new_err2"], e2["w"].numpy())
    # the compressed mean is the true mean to within the int8 resolution
    want = (res[0]["x"] + res[1]["x"]) / 2
    tol = max(np.abs(r["x"] + r["err"]).max() for r in res) / 127
    for r in res:
        assert np.abs(r["mean"] - want).max() <= tol
