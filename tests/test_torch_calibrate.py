"""repro_torch calibration (stats -> mirror-descent search -> mask bank)
against the JAX reference's, both run in the same test on the smoke llama
with the reference's own params and the launcher's defaults (wanda, 2:4,
median-normalised scores, 30 steps, 8 calibration batches of 4 x 64
tokens, stats over 4), and the banks of both packages loaded across.  The
search's pieces are held against the reference's in
tests/test_torch_search.py.  The committed bank under results/ came from
other weights than the reference's ``init_params(key(0))`` on this tree,
so nothing here compares with it.

Tolerances, and why:

* the stats (norms over 4 batches): rtol 2**-8, one bf16 unit.  The bf16
  matmul outputs that feed each projection differ from XLA's in the last
  place here and there (another accumulation order).
* the 30-step search on the reference's stats: Gamma/V within 1e-4 of the
  leaf's max|V| (observed 1.3e-5) and no mask differs.
* the whole 30-step calibration (each side computes its own stats): Gamma
  and V within 2**-8 (|V_ref| + lam) + 1e-4 max|V_ref| elementwise: the
  stats' tolerance carried through (V averages v_lr * S, and S scales with
  the stats), plus the search's own bound above for the weights that the
  prox drives toward 0 (observed: at most 0.41 of it).  A 2:4 mask may
  then differ from the reference's only in a group whose two swapped
  entries the reference scored within twice that tolerance of each other:
  every such near-tie is counted, printed and held to it.  The history:
  rtol 2e-3 (loss and nll carry bf16 units of ~90-sized logits; observed
  4.5e-4), atol 1e-6.
* banks: written by one package and read by the other, bit for bit, with
  the same checksum.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port import (assert_calibration_matches, f64, jax_flat,
                         leaf_pairs, smoke_llama, to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.core import calibrate as jcal
from repro.core import mirror as jmirror
from repro.launch import calibrate as jlaunch
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import mirror as tmirror
from repro_torch.launch import calibrate as tlaunch
from repro_torch.models import model as TM
from repro_torch.sparse.bank import MaskBank

ARCH = "llama3.2-1b"
PCFG = dict(local_metric="wanda", mode="nm", steps=30, stats_batches=4)
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def smoke():
    return smoke_llama()


def test_collect_stats_matches_reference(smoke):
    jcfg, cfg, jp, tp, calib = smoke
    want = jcal.collect_stats(jcfg, jp, calib,
                              pcfg=JaxPruneConfig(**PCFG))
    got = tcal.collect_stats(cfg, tp, calib, pcfg=PruneConfig(**PCFG))
    for path, jv, tv in leaf_pairs(want, got):
        np.testing.assert_allclose(f64(tv), f64(jv), rtol=BF16_ULP, atol=0,
                                   err_msg=path)


def test_collect_stats_raises_for_moe_layers():
    """MoE layers no longer raise: the expert-bank hook records every bank
    (stats (L, E, K)), and only an unknown impl raises.  The values are
    held against the reference's in tests/test_torch_tape.py."""
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), d_model=32,
                              num_layers=1, num_heads=2, num_kv_heads=1,
                              head_dim=16, moe_d_ff=32, vocab_size=64)
    params = TM.init_params(cfg, 0, device="cpu")
    calib = [{"tokens": np.zeros((1, 8), np.int32)}]
    for impl in ("jit", "tape"):
        stats = tcal.collect_stats(cfg, params, calib, impl=impl)
        got = {p.split("']['")[-2]: tuple(v.shape)
               for p, v in tree.flatten_with_path(stats) if v is not None
               and "['moe']" in p}
        assert got == {"up": (1, 8, 32), "gate": (1, 8, 32),
                       "down": (1, 8, 32)}, impl
    with pytest.raises(ValueError, match="unknown stats impl"):
        tcal.collect_stats(cfg, params, calib, impl="xla")


# --- the 30-step calibration, both packages, and their banks ----------------

@pytest.fixture(scope="module")
def calibrated(smoke, tmp_path_factory):
    jcfg, cfg, jp, tp, calib = smoke
    d = tmp_path_factory.mktemp("banks")
    jbank = jlaunch.calibrate_to_bank(
        d / "jax", cfg=jcfg, pcfg=JaxPruneConfig(**PCFG), params=jp,
        calib=calib, arch=ARCH, smoke=True, log_every=10)
    tbank = tlaunch.calibrate_to_bank(
        d / "torch", cfg=cfg, pcfg=PruneConfig(**PCFG), params=tp,
        calib=calib, arch=ARCH, smoke=True, log_every=10)
    return jbank, tbank, d


def test_search_on_reference_stats_matches_reference(smoke, calibrated):
    """The search alone: the port's 30 steps over the stats the reference
    computed end at the reference's Gamma and V, and at its masks."""
    jcfg, cfg, jp, tp, calib = smoke
    jbank, _, _ = calibrated
    stats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                          jax.device_get(jbank.stats))
    state, hist = tcal.run_search(cfg, PruneConfig(**PCFG), tp, calib, stats,
                                  log_every=10)
    assert state.step == 30 and len(hist) == 3
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jbank, name),
                                   getattr(state, name)):
            scale = np.abs(f64(jax_flat(jbank.V)[path])).max()
            np.testing.assert_allclose(f64(tv), f64(jv), rtol=0,
                                       atol=1e-4 * scale, err_msg=path)
    want = jmirror.export_masks(jbank.pcfg, jbank.Gamma, 0.5, V=jbank.V)
    got = tmirror.export_masks(PruneConfig(**PCFG), state.Gamma, 0.5,
                               V=state.V)
    for path, jv, tv in leaf_pairs(want, got):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=path)


def test_calibration_matches_reference(calibrated):
    jbank, tbank, _ = calibrated
    assert_calibration_matches(jbank, tbank)
    assert len(jbank.meta["history"]) == 3


def test_banks_load_across_packages_with_their_checksums(smoke, calibrated):
    jcfg, cfg, jp, tp, calib = smoke
    jbank, tbank, d = calibrated
    # the port's bank in the reference's loader, and the reverse
    from_t = JaxMaskBank.load(d / "torch")
    from_j = MaskBank.load(d / "jax", device="cpu")
    assert from_t.meta["checksum"] == tbank.meta["checksum"]
    assert from_j.meta["checksum"] == jbank.meta["checksum"]
    for key in ("schema", "format_version", "arch", "smoke", "pcfg",
                "steps_run", "stats_impl", "params_fingerprint"):
        assert tbank.meta[key] == jbank.meta[key], key
    assert tbank.meta["steps_run"] == 30
    for name in ("Gamma", "V", "stats"):
        for path, jv, tv in leaf_pairs(getattr(from_t, name),
                                   getattr(tbank, name)):
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                          err_msg=name + path)
        for path, jv, tv in leaf_pairs(getattr(jbank, name),
                                   getattr(from_j, name)):
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                          err_msg=name + path)
    # both loaders threshold the port's bank to the same masks
    for path, jv, tv in leaf_pairs(from_t.masks_at(), MaskBank.load(
            d / "torch", device="cpu").masks_at()):
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                      err_msg=path)
    # the fingerprint of the same weights agrees across packages
    assert tlaunch.params_fingerprint(tp) == jlaunch.params_fingerprint(jp)


def test_ensure_bank_reuses_a_matching_bank(smoke, calibrated):
    jcfg, cfg, jp, tp, calib = smoke
    _, tbank, d = calibrated
    again = tlaunch.ensure_bank(d / "torch", cfg=cfg,
                                pcfg=PruneConfig(**PCFG), params=tp,
                                calib=calib, arch=ARCH, smoke=True)
    assert again.meta["checksum"] == tbank.meta["checksum"]
    assert again.meta["search_seconds"] == tbank.meta["search_seconds"]


def test_unipruning_prune_applies_bank_masks(smoke):
    jcfg, cfg, jp, tp, calib = smoke
    pcfg = PruneConfig(**dict(PCFG, steps=2))
    out, state, hist = tcal.unipruning_prune(cfg, pcfg, tp, calib[:2])
    assert state.step == 2 and len(hist) == 1
    masks = tmirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    for path, w in tree.flatten_with_path(out[0.5]):
        m = dict(tree.flatten_with_path(masks))[path]
        w0 = dict(tree.flatten_with_path(tp))[path]
        want = w0 if m is None else w0 * m
        assert torch.equal(w, want), path
