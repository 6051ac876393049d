"""repro_torch's threefry stream (``core.prng``) against ``jax.random`` on
the CPU, bit for bit, and the stochria search and calibration that draw
from it against the JAX reference's, in one process.

Tolerances, and why:

* keys, ``split``, ``fold_in``, ``random_bits``, ``uniform`` and
  ``bernoulli``: exact (integer arithmetic; uniform compared by its bits).
* the stochria metric with a key: rtol 1e-6, atol 0, as ria and stochria
  in tests/test_torch_search.py (f32 row and column sums in another order);
  the draws themselves exact.
* a 5-step stochria search on the reference's stats: Gamma/V within 1e-4
  of the leaf's max|V|, as the 30-step wanda search in
  tests/test_torch_calibrate.py (observed 4.1e-6).  Its 2:4 masks may
  differ only in a group whose swapped entries the reference scored within
  twice the largest score difference between the two states, as that
  file's calibration counts near-ties (observed: 1 of 32768 groups, margin
  8.0e-7).  The 5-step stochria calibration (each side its own stats) at
  that file's calibration tolerances
  (``_torch_port.assert_calibration_matches``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (_near_ties, assert_calibration_matches, f64,
                         jax_flat, leaf_pairs, smoke_llama, to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.core import calibrate as jcal
from repro.core import metrics as jmetrics
from repro.core import mirror as jmirror
from repro.core.prunable import prunable_map as jprunable_map
from repro.launch import calibrate as jlaunch
from repro_torch import tree
from repro_torch.configs.base import PruneConfig
from repro_torch.core import calibrate as tcal
from repro_torch.core import metrics as tmetrics
from repro_torch.core import mirror as tmirror
from repro_torch.core import prng
from repro_torch.core.prunable import prunable_map
from repro_torch.launch import calibrate as tlaunch

SEEDS = (0, 1, 17, 2 ** 31 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40 + 3,
         2 ** 63 - 1, -1)
SHAPES = ((1,), (7,), (40,), (2048,), (3, 5))


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, np.uint32))


def _words(jkeys) -> list:
    return [tuple(k) for k in np.asarray(
        jax.random.key_data(jkeys)).reshape(-1, 2).tolist()]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_seed_match_jax(seed):
    # the reference's jax.random.key, in jax's default 32-bit mode
    assert prng.key(seed) == _words(jax.random.key(seed))[0]
    # threefry_seed of the 64-bit seed, as jax gives it with x64 on
    with jax.enable_x64(True):
        assert prng.threefry_seed(seed) == _words(jax.random.key(seed))[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match_jax(seed):
    key = prng.key(seed)
    jk = _jkey(key)
    for num in (2, 3):
        assert prng.split(key, num) == _words(jax.random.split(jk, num))
    for data in (0, 1, 29, 2 ** 31 + 7):
        assert prng.fold_in(key, data) == _words(
            jax.random.fold_in(jk, data))[0]
    # the search's chain: per step, then per leaf, then split
    k = prng.split(prng.fold_in(prng.fold_in(key, 4), 3))
    jk = jax.random.split(jax.random.fold_in(jax.random.fold_in(jk, 4), 3))
    assert k == _words(jk)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", (0, 17, 2 ** 32 + 5, 2 ** 40 + 3))
def test_draws_match_jax(seed, shape):
    key = prng.fold_in(prng.key(seed), 9)
    jk = _jkey(key)
    bits = prng.random_bits(key, shape)
    assert bits.shape == shape and bits.dtype == torch.int64
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax.random.bits(jk, shape)).astype(
            np.int64))
    u = prng.uniform(key, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        u.numpy().view(np.uint32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))
    for p in (0.9, 0.5, 1.0 / 3):
        np.testing.assert_array_equal(
            prng.bernoulli(key, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_stochria_with_key_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 48, 40)).astype(np.float32)
    a = np.abs(rng.standard_normal((2, 48))).astype(np.float32) + 0.1
    key = prng.fold_in(prng.key(17), 3)
    jk = _jkey(key)
    k1, k2 = jax.random.split(jk)
    row_w, col_w = tmetrics.stoch_weights(key, w.shape, 0.9, "cpu")
    np.testing.assert_array_equal(
        row_w.numpy(), np.asarray(jax.random.bernoulli(k1, 0.9, (40,)),
                                  np.float32))
    np.testing.assert_array_equal(
        col_w.numpy()[:, 0], np.asarray(jax.random.bernoulli(k2, 0.9, (48,)),
                                        np.float32))
    want = jax.jit(lambda w, a, k: jmetrics.stochria(w, a, key=k))(
        jnp.asarray(w), jnp.asarray(a), jk)
    got = tmetrics.stochria(torch.from_numpy(w), torch.from_numpy(a),
                            key=key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


# --- the search and the calibration, with stochria and a key ----------------

PCFG = dict(local_metric="stochria", mode="nm", steps=5, stats_batches=4)
ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def smoke():
    return smoke_llama()


def test_stochria_metric_tree_with_key_matches_reference(smoke):
    jcfg, cfg, jp, tp, calib = smoke
    jstats = jcal.collect_stats(jcfg, jp, calib[:1])
    tstats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                           jax.device_get(jstats))
    jk = jax.random.fold_in(jax.random.key(17), 2)
    want = jmetrics.metric_tree("stochria", jp, jstats, jprunable_map(jp),
                                key=jk, norm="median")
    got = tmetrics.metric_tree("stochria", tp, tstats, prunable_map(tp),
                               key=prng.fold_in(prng.key(17), 2),
                               norm="median")
    pairs = leaf_pairs(want, got)
    assert len(pairs) == 7
    for path, jv, tv in pairs:
        np.testing.assert_allclose(f64(tv), f64(jv), rtol=1e-6, atol=0,
                                   err_msg=path)
    # a different key draws other rows and columns
    other = tmetrics.metric_tree("stochria", tp, tstats, prunable_map(tp),
                                 key=prng.key(18), norm="median")
    assert any(not torch.equal(tv, dict(tree.flatten_with_path(other))[p])
               for p, _, tv in pairs)


def _scores(Gamma: dict, V: dict) -> dict:
    """path -> |Gamma| + eps |V| in float64, the scores export_masks ranks,
    from path -> leaf dicts of either package."""
    G = {p: f64(g) for p, g in Gamma.items() if g is not None}
    Vs = {p: f64(V[p]) for p in G}
    gmax = max(np.abs(g).max() for g in G.values())
    vmax = max(np.abs(v).max() for v in Vs.values())
    return {p: np.abs(G[p]) + 1e-6 * gmax / vmax * np.abs(Vs[p]) for p in G}


@pytest.fixture(scope="module")
def stoch_calibrated(smoke, tmp_path_factory):
    jcfg, cfg, jp, tp, calib = smoke
    d = tmp_path_factory.mktemp("stoch_banks")
    jbank = jlaunch.calibrate_to_bank(
        d / "jax", cfg=jcfg, pcfg=JaxPruneConfig(**PCFG), params=jp,
        calib=calib, arch=ARCH, smoke=True, log_every=2)
    tbank = tlaunch.calibrate_to_bank(
        d / "torch", cfg=cfg, pcfg=PruneConfig(**PCFG), params=tp,
        calib=calib, arch=ARCH, smoke=True, log_every=2)
    return jbank, tbank


def test_stochria_search_with_key_matches_reference(smoke,
                                                    stoch_calibrated):
    """5 stochria steps from the search seed over the reference's stats
    end at the reference's Gamma, V and masks."""
    jcfg, cfg, jp, tp, calib = smoke
    jbank, _ = stoch_calibrated
    stats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                          jax.device_get(jbank.stats))
    state, hist = tcal.run_search(cfg, PruneConfig(**PCFG), tp, calib, stats,
                                  log_every=2)
    assert state.step == 5 and len(hist) == 3
    assert state.rng == prng.key(17) == _words(jax.random.key(17))[0]
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jbank, name),
                                       getattr(state, name)):
            scale = np.abs(f64(jax_flat(jbank.V)[path])).max()
            np.testing.assert_allclose(f64(tv), f64(jv), rtol=0,
                                       atol=1e-4 * scale, err_msg=path)
    # masks: equal but for groups whose reference scores lie within twice
    # the largest score difference between the two states
    want = jmirror.export_masks(jbank.pcfg, jbank.Gamma, 0.5, V=jbank.V)
    got = tmirror.export_masks(PruneConfig(**PCFG), state.Gamma, 0.5,
                               V=state.V)
    jscore = _scores(jax_flat(jbank.Gamma), jax_flat(jbank.V))
    tscore = _scores(dict(tree.flatten_with_path(state.Gamma)),
                     dict(tree.flatten_with_path(state.V)))
    ties = 0
    for path, jk, tk in leaf_pairs(want, got):
        diff = np.abs(tscore[path] - jscore[path]).max()
        for idx, margin, tol in _near_ties(
                jscore[path], np.asarray(jk), tk.numpy(),
                np.full(jscore[path].shape, diff)):
            print(f"near-tie {path}{list(map(int, idx))}: reference margin "
                  f"{margin:.3e} <= {tol:.3e}")
            assert 0 <= margin <= tol, (path, idx, margin, tol)
            ties += 1
    n = sum(int(np.asarray(m).size) for m in jax.tree.leaves(want))
    assert ties <= n // 4 // 1000
    # another seed draws other subsets from step 0: the key is what matched
    other, _ = tcal.run_search(cfg, PruneConfig(**dict(PCFG, steps=1)), tp,
                               calib, stats, seed=18)
    first, _ = tcal.run_search(cfg, PruneConfig(**dict(PCFG, steps=1)), tp,
                               calib, stats)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree.leaves(other.V), tree.leaves(first.V)) if a is not None)


def test_stochria_calibration_matches_reference(stoch_calibrated):
    jbank, tbank = stoch_calibrated
    assert jbank.pcfg.local_metric == tbank.pcfg.local_metric == "stochria"
    assert_calibration_matches(jbank, tbank)
    assert len(jbank.meta["history"]) == 3
