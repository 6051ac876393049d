"""repro_torch's calibration of the smoke deepseek-v2-lite-16b against the
JAX reference's, in one process: the stats pass over the new leaves (MLA's
``w_uk`` / ``w_uv`` see the normalised latent ``c_kv``, the shared MLP
every token, the expert banks their routed rows) and a short wanda 2:4
search (``saliency_fused_step``, ``prox24`` and ``nm_mask24``'s plain
versions over the MLA, shared and expert leaves) on the reference's stats.

One set of params (the port's ``init_params``, seed 0) is carried to the
reference; one calibration batch of 4 x 32 tokens routes rows to every
expert of both MoE layers.

Tolerances, and why (tests/test_torch_tape.py's MoE rules, ROADMAP R12):

* the stats: the prefix layer's (before any MoE layer) within rtol 2**-8
  (the jitted pass's roundings mirrored, sums taken in another order);
  each expert bank (layers, E, K) within 1e-2 of its Frobenius norm (a
  token that routes to the other expert of a near-tied pair moves one
  (layer, expert) row); every other leaf of the ``mla_moe`` stage within
  rtol 1e-2, as tests/test_torch_gemma_eval.py holds gemma3's: its inputs
  come after an MoE layer whose output carries those rows (measured at
  most 4.4e-3, the shared MLP's down projection in the second MoE layer;
  1.4e-3 elsewhere);
* the search, on the reference's stats (R5): Gamma and V within 1e-4 of
  the leaf's max |V|, the 2:4 masks equal but for counted near-ties of
  the reference's own scores.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import (_near_ties, f64, jax_flat, leaf_pairs,
                         one_torch_thread, to_torch)  # noqa: F401
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.core import mirror as jmirror
from repro.data.synthetic import batches_for
from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import mirror as tmirror
from repro_torch.models import model as TM

ARCH = "deepseek-v2-lite-16b"
PCFG = dict(local_metric="wanda", mode="nm", steps=2, stats_batches=1)


@pytest.fixture(scope="module")
def smoke():
    """cfgs, params in both packages, the calibration batch, and the
    reference's stats."""
    import jax.numpy as jnp
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tp = TM.init_params(cfg, 0, device="cpu")
    jp = tree.tree_map(lambda a: jnp.asarray(a.numpy()), tp)
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")
    stats = jcal.collect_stats(jcfg, jp, calib, pcfg=JaxPruneConfig(**PCFG))
    return jcfg, cfg, jp, tp, calib, stats


def test_stats_match_reference(smoke):
    jcfg, cfg, jp, tp, calib, want = smoke
    got = tcal.collect_stats(cfg, tp, calib, pcfg=PruneConfig(**PCFG))
    pairs = leaf_pairs(want, got)
    assert len(pairs) == 19         # every prunable leaf has its stats
    for path, jv, tv in pairs:
        assert tuple(tv.shape) == tuple(jv.shape), path
        w, g = f64(jv), f64(tv)
        if "['moe']['" in path and "shared" not in path:   # (L, E, K)
            assert tv.dim() == 3 and (w.sum(axis=-1) > 0).all(), path
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= 1e-2, (path, err)
        else:
            rtol = 2 ** -8 if path.startswith("['stages'][0]") else 1e-2
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=path)


def test_search_matches_reference_on_its_stats(smoke):
    jcfg, cfg, jp, tp, calib, stats = smoke
    jpcfg, pcfg = JaxPruneConfig(**PCFG), PruneConfig(**PCFG)
    jstate, _ = jcal.run_search(jcfg, jpcfg, jp, calib, stats)
    tstats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                           jax.device_get(stats))
    state, hist = tcal.run_search(cfg, pcfg, tp, calib, tstats,
                                  log_every=1)
    assert state.step == PCFG["steps"] and len(hist) == PCFG["steps"]
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jstate, name),
                                       getattr(state, name)):
            scale = np.abs(f64(jax_flat(jstate.V)[path])).max()
            np.testing.assert_allclose(f64(tv), f64(jv), rtol=0,
                                       atol=1e-4 * scale, err_msg=name + path)
    jm = jmirror.export_masks(jpcfg, jstate.Gamma, 0.5, V=jstate.V)
    tm = tmirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    ties, n = 0, 0
    for path, jk, tk in leaf_pairs(jm, tm):
        jk, tk = np.asarray(jk), tk.numpy()
        n += jk.size // 4
        if (jk != tk).any():
            G = f64(jax_flat(jstate.Gamma)[path])
            err = np.abs(f64(dict(tree.flatten_with_path(
                state.Gamma))[path]) - G)
            for _, margin, tol in _near_ties(np.abs(G), jk, tk,
                                             np.full_like(G, err.max())):
                assert 0 <= margin <= tol, (path, margin, tol)
                ties += 1
    print(f"deepseek smoke: {ties} near-tied groups of {n} differ")
    assert ties <= 2
