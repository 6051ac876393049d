"""repro_torch's recurrent mixers (``models/ssm.py``: Mamba2;
``models/xlstm.py``: mLSTM, sLSTM) against the JAX reference on the CPU,
and tests/test_ssm.py's chunked-vs-recurrent oracles on the port.

Inputs are drawn by numpy from a seed; params by the port's Builder
(seed 0), carried to the reference as jax arrays, with the zero-init
norm scales, biases and mLSTM gate biases drawn too so that every term
counts.  The reference runs jitted (its roundings: ROADMAP R6).

Tolerances, and why:

* block outputs (bf16): 1 bf16 ulp of the output's largest value.
  Measured: Mamba2 0.005 ulp (one element), sLSTM 0; mLSTM up to 0.98
  ulp, where its bf16 matmuls (up, wq, wk, wv) round an element to the
  other neighbour in 1e-4 of cases (another summation order) and the
  matrix memory carries it;
* the f32 states: 1e-3 of the leaf's largest value (measured: Mamba2
  1e-6, the chunk combine is a sequential loop where the reference's
  ``associative_scan`` runs a tree: f32 rounding only; sLSTM 7e-4, mLSTM
  3e-4 from the same bf16 rounding flips); the conv histories (bf16)
  exactly;
* the sLSTM gradient (the reference's hand-written ``custom_vjp``, the
  port's autograd through its time loop), f32 throughout: rtol 1e-4 of
  each gradient's largest value;
* the port's own chunked-vs-recurrent oracles: tests/test_ssm.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread, to_jax  # noqa: F401
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro_torch import tree
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.models.common import Builder

D_MODEL, D_INNER, D_STATE, HD = 64, 128, 16, 16
H = 2


def _params(init, seed=0, perturb=True, **kw):
    """Port params drawn with seed ``seed``, the zero-init norm scales and
    biases drawn too (N(0, 0.1)) where ``perturb``; and the same as jax
    arrays."""
    g = torch.Generator().manual_seed(seed)
    p = init(Builder("init", g, "cpu"), **kw)
    if perturb:
        p = tree.map_with_path(
            lambda path, a: a + 0.1 * torch.randn(a.shape, generator=g)
            if path.endswith(("['scale']", "bias']")) else a, p)
    return p, to_jax(p)


def _x(seed, B, S, d=D_MODEL):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    return t.to(torch.bfloat16)


def _close_ulps(got, want, ulps=1.0, what=""):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=ulps * 2 ** -8 * np.abs(w).max(),
                               err_msg=what)


def _close_state(got, want, what=""):
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)
        return
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-3 * np.abs(w).max(), err_msg=what)


MAMBA = dict(d_inner=D_INNER, d_state=D_STATE, head_dim=HD)


@pytest.mark.parametrize("S,chunk", [(45, 16), (32, 32), (7, 256)])
def test_mamba2_full_and_decode_match_reference(S, chunk):
    """The chunked prefill (S not a chunk multiple: dt = 0 padding; one
    chunk; a prompt shorter than the chunk) with its returned state, then
    3 decode steps from that state."""
    p, jp = _params(tssm.mamba2_init, d_model=D_MODEL, **MAMBA)
    x = _x(S, 2, S)
    jy, jst = jax.jit(lambda p, x: jssm.mamba2_apply_full(
        p, x, chunk=chunk, return_state=True, **MAMBA))(jp, to_jax(x))
    ty, tst = tssm.mamba2_apply_full(p, x, chunk=chunk, return_state=True,
                                     **MAMBA)
    _close_ulps(ty, jy, what="prefill")
    for k in ("h", "conv"):
        _close_state(tst[k], jst[k], k)
    jdec = jax.jit(lambda p, x, s: jssm.mamba2_apply_decode(p, x, s,
                                                            **MAMBA))
    for i in range(3):
        xi = _x(100 + i, 2, 1)
        jo, jst = jdec(jp, to_jax(xi), jst)
        to, tst2 = tssm.mamba2_apply_decode(p, xi, tst, **MAMBA)
        assert tst2 is tst          # updated in place
        _close_ulps(to, jo, what=f"decode {i}")
        for k in ("h", "conv"):
            _close_state(tst[k], jst[k], f"{k} after step {i}")


@pytest.mark.parametrize("S,chunk", [(21, 8), (16, 256)])
def test_mlstm_full_and_decode_match_reference(S, chunk):
    p, jp = _params(txl.mlstm_init, d_model=D_MODEL, num_heads=H)
    x = _x(S + 1, 2, S)
    jy, jst = jax.jit(lambda p, x: jxl.mlstm_apply_full(
        p, x, num_heads=H, chunk=chunk, return_state=True))(jp, to_jax(x))
    ty, tst = txl.mlstm_apply_full(p, x, num_heads=H, chunk=chunk,
                                   return_state=True)
    _close_ulps(ty, jy, what="prefill")
    for k in tst:
        _close_state(tst[k], jst[k], k)
    jdec = jax.jit(lambda p, x, s: jxl.mlstm_apply_decode(p, x, s,
                                                          num_heads=H))
    for i in range(3):
        xi = _x(200 + i, 2, 1)
        jo, jst = jdec(jp, to_jax(xi), jst)
        to, _ = txl.mlstm_apply_decode(p, xi, tst, num_heads=H)
        _close_ulps(to, jo, what=f"decode {i}")
        for k in tst:
            _close_state(tst[k], jst[k], f"{k} after step {i}")


def test_slstm_full_and_decode_match_reference():
    p, jp = _params(txl.slstm_init, d_model=D_MODEL, num_heads=H)
    x = _x(3, 2, 19)
    jy, jst = jax.jit(lambda p, x: jxl.slstm_apply(
        p, x, None, num_heads=H, return_state=True))(jp, to_jax(x))
    ty, tst = txl.slstm_apply(p, x, None, num_heads=H, return_state=True)
    _close_ulps(ty, jy, what="prefill")
    for k in tst:
        _close_state(tst[k], jst[k], k)
    jdec = jax.jit(lambda p, x, s: jxl.slstm_apply(p, x, s, num_heads=H,
                                                   return_state=True))
    for i in range(3):
        xi = _x(300 + i, 2, 1)
        jo, jst = jdec(jp, to_jax(xi), jst)
        to, st = txl.slstm_apply(p, xi, tst, num_heads=H, return_state=True)
        assert st is tst            # updated in place
        _close_ulps(to, jo, what=f"decode {i}")
        for k in tst:
            _close_state(tst[k], jst[k], f"{k} after step {i}")


def test_slstm_gradient_matches_reference_custom_vjp():
    """d/d(gates, r, initial state) of a weighted sum of the scan's h and
    its final state: the reference's hand-written BPTT (``_slstm_bwd``)
    against autograd through the port's time loop."""
    p, jp = _params(txl.slstm_init, d_model=D_MODEL, num_heads=H)
    B, S, d = 2, 11, D_MODEL
    rng = np.random.default_rng(7)
    gates = rng.standard_normal((B, S, 4 * d)).astype(np.float32)
    w = rng.standard_normal((B, S, d)).astype(np.float32)
    wc = rng.standard_normal((B, H, d // H)).astype(np.float32)
    st0 = txl.slstm_init_state(B, d_model=d, num_heads=H, device="cpu")
    st0["c"] = torch.from_numpy(
        rng.standard_normal((B, H, d // H)).astype(np.float32))
    r = p["r"]["kernel"]

    def jloss(g, r, c0):
        st = {"c": c0, "n": jnp.asarray(st0["n"].numpy()),
              "m": jnp.asarray(st0["m"].numpy()),
              "h": jnp.asarray(st0["h"].numpy())}
        h, new = jxl.slstm_core({"r": {"kernel": r}}, g, st, num_heads=H)
        return jnp.sum(h * w) + jnp.sum(new["c"] * wc)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(gates), jnp.asarray(r.numpy()),
        jnp.asarray(st0["c"].numpy()))
    tg = torch.from_numpy(gates).requires_grad_()
    tr = r.clone().requires_grad_()
    tc0 = st0["c"].clone().requires_grad_()
    h, new = txl.slstm_core({"r": {"kernel": tr}}, tg,
                            {**st0, "c": tc0}, num_heads=H)
    loss = (h * torch.from_numpy(w)).sum() + (
        new["c"] * torch.from_numpy(wc)).sum()
    loss.backward()
    for got, want, what in ((tg.grad, jg[0], "gates"), (tr.grad, jg[1], "r"),
                            (tc0.grad, jg[2], "c0")):
        w_ = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w_, rtol=0,
                                   atol=1e-4 * np.abs(w_).max(),
                                   err_msg=what)


# ---------------------------------------------------------------------------
# tests/test_ssm.py's oracles on the port, at its init (no perturbation)
# and its sizes and its f32 x (the projections promote to f32, as JAX's)
# ---------------------------------------------------------------------------

def test_mamba2_chunked_matches_recurrent():
    p, _ = _params(tssm.mamba2_init, perturb=False, d_model=32, d_inner=64, d_state=16,
                   head_dim=16)
    kw = dict(d_inner=64, d_state=16, head_dim=16)
    x = 0.5 * _x(1, 2, 48, 32).float()
    y_full, st_full = tssm.mamba2_apply_full(p, x, chunk=16,
                                             return_state=True, **kw)
    st = tssm.mamba2_init_state(2, device="cpu", **kw)
    y_seq = torch.cat([tssm.mamba2_apply_decode(p, x[:, t:t + 1], st,
                                                **kw)[0]
                       for t in range(48)], dim=1)
    np.testing.assert_allclose(y_full.float().numpy(),
                               y_seq.float().numpy(), rtol=3e-2, atol=1e-2)
    np.testing.assert_allclose(st_full["h"].numpy(), st["h"].numpy(),
                               rtol=3e-2, atol=3e-3)


def test_mamba2_nondivisible_length_padding_and_short_prefill_state():
    """The dt = 0 padding is a state no-op; a prefill shorter than the
    conv width leaves the history a blank start would (zeros in front):
    the port's history of a 2-token prefill equals 2 decode steps from
    the blank state (the reference broadcasts the last row over the
    history there: ROADMAP C)."""
    kw = dict(d_inner=32, d_state=8, head_dim=8)
    p, _ = _params(tssm.mamba2_init, perturb=False, d_model=16,
                   **kw)
    x = 0.5 * _x(2, 1, 37, 16).float()
    y, st = tssm.mamba2_apply_full(p, x, chunk=16, return_state=True, **kw)
    assert y.shape == (1, 37, 16) and not bool(torch.isnan(y).any())
    y2, _ = tssm.mamba2_apply_full(p, x[:, :32], chunk=16, **kw)
    np.testing.assert_allclose(y[:, :32].float().numpy(),
                               y2.float().numpy(), rtol=2e-2, atol=2e-3)
    _, short = tssm.mamba2_apply_full(p, x[:, :2], chunk=16,
                                      return_state=True, **kw)
    blank = tssm.mamba2_init_state(1, device="cpu", **kw)
    for t in range(2):
        tssm.mamba2_apply_decode(p, x[:, t:t + 1], blank, **kw)
    assert torch.equal(short["conv"], blank["conv"])
    np.testing.assert_allclose(short["h"].numpy(), blank["h"].numpy(),
                               rtol=3e-2, atol=3e-3)


def test_mlstm_chunked_matches_step():
    p, _ = _params(txl.mlstm_init, perturb=False, d_model=32,
                   num_heads=H)
    x = 0.5 * _x(1, 1, 40, 32).float()
    y_full, st_full = txl.mlstm_apply_full(p, x, num_heads=H, chunk=8,
                                           return_state=True)
    st = txl.mlstm_init_state(1, d_inner=64, num_heads=H, device="cpu")
    y_seq = torch.cat([txl.mlstm_apply_decode(p, x[:, t:t + 1], st,
                                              num_heads=H)[0]
                       for t in range(40)], dim=1)
    np.testing.assert_allclose(y_full.float().numpy(),
                               y_seq.float().numpy(), rtol=3e-2, atol=3e-3)
    np.testing.assert_allclose(st_full["C"].numpy(), st["C"].numpy(),
                               rtol=3e-2, atol=3e-3)


def test_slstm_state_continuity():
    p, _ = _params(txl.slstm_init, perturb=False, d_model=32,
                   num_heads=H)
    x = 0.5 * _x(1, 1, 24, 32).float()
    y_full, st_full = txl.slstm_apply(p, x, None, num_heads=H,
                                      return_state=True)
    _, st_a = txl.slstm_apply(p, x[:, :12], None, num_heads=H,
                              return_state=True)
    y_b, st_b = txl.slstm_apply(p, x[:, 12:], st_a, num_heads=H,
                                return_state=True)
    np.testing.assert_allclose(y_full[:, 12:].float().numpy(),
                               y_b.float().numpy(), rtol=2e-2, atol=2e-3)
    for k in ("c", "n", "m", "h"):
        np.testing.assert_allclose(st_full[k].numpy(), st_b[k].numpy(),
                                   rtol=2e-2, atol=2e-3)
