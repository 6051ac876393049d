"""The measurements behind two of the port's recorded caveats, printed.
JAX and the port in one process on the CPU, as the parity tests run them
(not collected by pytest: it takes a few minutes).

  PYTHONPATH=src:tests python tests/torch_port_evidence.py c3
  PYTHONPATH=src:tests python tests/torch_port_evidence.py spread

``c3`` (ROADMAP C3 / R23, calibrating from the port's own stats):

* the fusion of the jitted reference's stats pass (smoke whisper-small)
  that feeds the decoder ``mlp.down``'s sum of squares, as XLA compiled
  it: which ops convert to bf16;
* each prunable leaf's stats, the port's jit pass and the reference's
  tape pass against the reference's jit pass (relative norm, and the
  largest per-feature error of ``||X_j||``), whisper and pixtral;
* 5-step wanda 2:4 calibrations: the V entries past
  ``assert_calibration_matches``'s bound, the port's own stats and the
  reference's own tape stats each against the reference's jit stats;
* the attention block on identical bf16 inputs: output elements that
  differ, and the flips of q / k / v (the bf16 matmuls' summation order)
  that seed them;
* gemma3's rope: the share of f32 cos / sin values where XLA's CPU
  functions and torch's differ.

``spread`` (tests/test_torch_train_families.py's and chip_smoke.py
phase 16's tolerances): the reference's own eager step against its
jitted one on smoke deepseek and smoke zamba2 (params, update, moments),
and its own eager gradients against its jitted ones on the 12-layer
zamba2's shared and LoRA leaves.
"""
from __future__ import annotations

import dataclasses
import re
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import (f64, global_rel, jax_flat, smoke_with_24, to_jax,
                         to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.data.synthetic import batches_for
from repro.launch import calibrate as jlaunch
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import model as JM
from repro.optim import losses as jlosses
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.launch import calibrate as tlaunch
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import model as TM

PCFG = dict(local_metric="wanda", mode="nm", steps=5, stats_batches=1)


def _jx(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _hlo_down_fusion() -> None:
    jcfg = jax_smoke_config("whisper-small")
    params = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")[0]
    spec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in calib.items()}
    text = jax.jit(lambda p, b: JM.stats_sumsq(jcfg, p, b)).lower(
        params, spec).compile().as_text()
    # the fusion computing the square of the down projection's input: the
    # last one whose root is a square fed by a product with tanh upstream
    comps = re.split(r"\n(?=%)", text)
    for comp in comps:
        head = comp.split("\n", 1)[0]
        if "square" in comp and "ROOT %square" in comp and \
                comp.count("convert(") >= 6:
            print("  fusion", head.split(" ")[0], "ops, in order:")
            for line in comp.split("\n")[1:]:
                m = re.match(r"\s*(ROOT )?%(\S+) = (\w+)\[[^]]*\]\S* "
                             r"(\w+)\(", line)
                if m:
                    print(f"    {m.group(2)}: {m.group(4)} -> {m.group(3)}")
            return
    print("  no fusion found")


def _stats(arch: str) -> dict:
    m = smoke_with_24(arch)
    jcfg, cfg = m["cfg"]
    jp, tp = m["dense"]
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")

    def flat(t):
        return dict(tree.flatten_with_path(tree.tree_map(
            lambda a: None if a is None else to_torch(a).double(),
            jax.device_get(t))))
    want = flat(jcal.collect_stats(jcfg, jp, calib))
    rtape = flat(jcal.collect_stats(jcfg, jp, calib, impl="tape"))
    got = dict(tree.flatten_with_path(tcal.collect_stats(cfg, tp, calib)))
    for path, g in got.items():
        if g is None:
            continue
        j, g, t = want[path], g.double(), rtape[path]
        feat = lambda a: float(((a.sqrt() - j.sqrt()).abs()
                                / j.sqrt()).max())
        print(f"  {path}: port {float((g - j).norm() / j.norm()):.2e} "
              f"(feature {feat(g):.2e}), reference tape "
              f"{float((t - j).norm() / j.norm()):.2e} (feature "
              f"{feat(t):.2e})")
    return m


def _violations(jbank, V: dict) -> dict:
    out = {}
    for path, jv in jax_flat(jbank.V).items():
        if jv is None:
            continue
        a = f64(jv)
        tol = 2.0 ** -8 * (np.abs(a) + jbank.pcfg.lam) + 1e-4 * np.abs(a).max()
        err = np.abs(f64(V[path]) - a)
        if (err >= tol).any():
            out[path] = (int((err >= tol).sum()), a.size,
                         round(float((err / tol).max()), 3))
    return out


def _calibrations(arch: str, m: dict) -> None:
    jcfg, cfg = m["cfg"]
    jp, tp = m["dense"]
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")
    d = tempfile.mkdtemp()
    kw = dict(pcfg=JaxPruneConfig(**PCFG), params=jp, calib=calib, arch=arch,
              smoke=True, log_every=0)
    jit = jlaunch.calibrate_to_bank(f"{d}/jit", cfg=jcfg, **kw)
    tape = jlaunch.calibrate_to_bank(f"{d}/tape", cfg=jcfg,
                                     stats_impl="tape", **kw)
    port = tlaunch.calibrate_to_bank(
        f"{d}/port", cfg=cfg, pcfg=PruneConfig(**PCFG), params=tp,
        calib=calib, arch=arch, smoke=True, log_every=0)
    print(f"  V past the bound (entries, of, worst / bound): port's own "
          f"stats {_violations(jit, dict(tree.flatten_with_path(port.V)))}")
    print(f"  the reference's tape stats {_violations(jit, jax_flat(tape.V))}")


def _attention(arch: str, m: dict, causal: bool, stage: str) -> None:
    jcfg, cfg = m["cfg"]
    jp, tp = m["dense"]
    B, S = 4, 32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
              head_dim=cfg.head_dim, use_rope=False, causal=causal)
    pos = torch.zeros((B, S), dtype=torch.long)
    tpl = tree.tree_map(lambda a: a[0], tp[stage][0]["0"]["attn"])
    jpl = jax.tree.map(lambda a: a[0], jp[stage][0]["0"]["attn"])
    ty, _ = TA.attn_apply_full(tpl, x, positions=pos, **kw)
    jy, _ = jax.jit(lambda p, x: JA.attn_apply_full(
        p, x, positions=jnp.zeros((B, S), jnp.int32), **kw))(jpl, _jx(x))
    flips = {}
    for name in ("wq", "wk", "wv"):
        t = TC.dense(tpl[name], x).float().numpy()
        j = np.asarray(jax.jit(lambda p, x: x @ p["kernel"].astype(
            jnp.bfloat16))(jpl[name], _jx(x)), np.float32)
        flips[name] = int((t != j).sum())
    print(f"  {arch} attention block: {int((ty.float().numpy() != np.asarray(jy, np.float32)).sum())} "  # noqa: E501
          f"of {ty.numel()} outputs differ; q / k / v flips {flips} of "
          f"{B * S * cfg.num_heads * cfg.head_dim} each")


def _cos_sin() -> None:
    c = jax_smoke_config("gemma3-1b")
    n = diff = 0
    for theta in (c.rope_theta, c.local_rope_theta):
        half = c.head_dim // 2
        freq = theta ** (-torch.arange(0, half, dtype=torch.float32) / half)
        ang = torch.arange(32).float()[:, None] * freq
        for tf, jf in ((torch.cos, jnp.cos), (torch.sin, jnp.sin)):
            t = tf(ang).numpy()
            j = np.asarray(jax.jit(jf)(jnp.asarray(ang.numpy())))
            n += t.size
            diff += int((t != j).sum())
            print(f"  theta {theta:g} {tf.__name__}: {int((t != j).sum())} "
                  f"of {t.size} differ, at most "
                  f"{float(np.abs(t - j).max() / np.spacing(np.float32(1))):.1f}"  # noqa: E501
                  " eps")
    print(f"  gemma3 rope: {diff} of {n} values ({diff / n:.1%})")


def c3() -> None:
    print("the reference's compiled stats pass, smoke whisper-small:")
    _hlo_down_fusion()
    for arch, causal, stage in (("whisper-small", False, "enc_stages"),
                                ("pixtral-12b", True, "stages")):
        print(f"{arch} stats against the reference's jit pass:")
        m = _stats(arch)
        _calibrations(arch, m)
        _attention(arch, m, causal, stage)
    _cos_sin()


def _step_spread(arch: str, accum: int) -> None:
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp0 = jax.tree.map(lambda a: jnp.array(a, copy=True),
                       to_jax(TM.init_params(cfg, 0, device="cpu")))
    b = {k: jnp.asarray(v) for k, v in batches_for(
        jcfg, n=1, batch=4, seq=32, split="train")[0].items()}
    step = jsteps.make_train_step(jcfg, jopt.AdamWConfig(
        lr=3e-4, total_steps=1, warmup_steps=1), accum=accum, remat=True)
    jp, js, _ = jax.jit(step)(jp0, jopt.adamw_init(jp0), b)
    with jax.disable_jit():
        ep, es, _ = step(jp0, jopt.adamw_init(jp0), b)
    tp = lambda t: tree.tree_map(lambda a: None if a is None else
                                 to_torch(a), jax.device_get(t))
    print(f"{arch} (accum {accum}): the reference's eager step against its "
          f"jitted one: params {global_rel(jp, tp(ep)):.3e}, of the update "
          f"{global_rel(jp, tp(ep), base=jp0):.3f}, moments "
          f"{max(global_rel(js.mu, tp(es.mu)), global_rel(js.nu, tp(es.nu))):.3f}")  # noqa: E501


def spread() -> None:
    _step_spread("deepseek-v2-lite-16b", 2)
    _step_spread("zamba2-7b", 1)

    over = dict(num_layers=12)
    jcfg = dataclasses.replace(jax_smoke_config("zamba2-7b"), **over)
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"), **over)
    g = torch.Generator().manual_seed(1)
    jp = to_jax(tree.map_with_path(
        lambda path, a: a + 0.02 * torch.randn(a.shape, generator=g)
        if "lora" in path and path.endswith("['b']") else a,
        TM.init_params(cfg, 0, device="cpu")))
    tokens = jnp.asarray(batches_for(jcfg, n=1, batch=4, seq=32,
                                     split="train")[0]["tokens"])
    loss = lambda p: jlosses.lm_loss(jcfg, p, {"tokens": tokens},
                                     remat=True)[0]
    jg = jax_flat(jax.jit(jax.grad(loss))(jp))
    with jax.disable_jit():
        eg = jax_flat(jax.grad(loss)(jp))
    for path, w in jg.items():
        if path.startswith("['shared']") or "lora" in path:
            w = f64(w)
            print(f"zamba2 (12 layers) {path}: the reference's eager "
                  f"gradient {np.linalg.norm(f64(eg[path]) - w) / np.linalg.norm(w):.2e}"  # noqa: E501
                  " from its jitted one")


if __name__ == "__main__":
    torch.set_num_threads(1)        # as the parity tests run
    {"c3": c3, "spread": spread}[sys.argv[1]]()
