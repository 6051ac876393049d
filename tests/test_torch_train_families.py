"""repro_torch's train step (``launch.steps.make_train_step``) on the
families tests/test_torch_train.py does not meet: one AdamW step each on
smoke gemma2-2b (the logit softcaps' backward), gemma3-1b (sandwich
norms, QK-norm, local layers), yi-6b, deepseek-v2-lite-16b (MLA's
backward, routed and shared experts), zamba2-7b (Mamba2, and the shared
attention block with its per-layer LoRA) and xlstm-125m (mLSTM, and
sLSTM's time loop), against the reference's jitted ``make_train_step``
from the same params; then zamba2's ``params["shared"]`` gradients leaf
by leaf, and the whole sLSTM layer's gradient against ``jax.grad``
through the reference's hand-written BPTT (``custom_vjp``).

The params are drawn by the port's ``init_params`` (seed 0) and carried
to the reference with ``to_jax`` (the reference's own init compiles one
program a leaf shape).  The batch is the loader's (``batches_for``, 4 x
32 tokens of the train split).

Tolerances, and why (tests/test_torch_train.py's, ROADMAP R14, where
they hold for the reference itself):

* loss and grad_norm: rtol 2e-3 and 1e-2 on the dense families, 1e-2 and
  3e-2 on deepseek, whose routing near-ties move a token to another
  expert; lr to 2**-22;
* params: ``||p - p_ref|| <= 2e-4 ||p_ref||`` over the tree and, of the
  reference's own update, ``||p - p_ref|| <= 0.12 ||p_ref - p0||`` on
  the dense families and 0.25 on deepseek.  Adam's first step moves each
  weight by about lr times its gradient's sign, so a weight whose
  gradient is within rounding of zero moves the other way: held in
  norm, never elementwise.  On deepseek the reference's own eager step
  is 0.266 of the update from its jitted one (rel 2.3e-4, moments 0.13;
  tests/torch_port_evidence.py ``spread``), so R14's 0.12 does not hold
  for the reference itself; the port measures 0.205 (rel 1.8e-4,
  moments 0.050).  mu and nu over the tree within 2e-2 (dense) and 0.2
  (deepseek) in relative norm;
* zamba2's shared block, at 12 layers (two ``mamba_shared`` invocations,
  each with its own LoRA deltas, their zero-init ``b`` factors drawn so
  that every LoRA gradient counts): each gradient leaf of
  ``params["shared"]`` and of the LoRA factors within 0.1 of the
  reference's in relative norm.  Measured 3.7e-2 to 5.1e-2; the
  reference's own eager gradients are 7.6e-2 to 9.3e-2 from its jitted
  ones on the same leaves (``spread``): bf16 roundings carried through
  12 random-weight layers.  A shared leaf missing one invocation's
  share would be off by about half;
* the sLSTM layer (``slstm_apply``: the input projection, the time loop,
  the norm and the gated feed-forward; 64 steps; f32 input, so that
  only the weights' bf16 roundings enter, the same on both sides): each
  gradient leaf, and the input's, within 2e-4 of the reference's in
  relative norm (measured 6.8e-5 at most, ``ff_up``).  The port's
  autograd through its time loop is held to the reference's hand-written
  reverse loop (``_slstm_bwd``), and kept: no ``autograd.Function`` is
  needed;
* Mamba2's chunked scan where ``exp`` of a masked segment sum overflows:
  the reference's gradient is NaN there (R24), the port's is finite and
  its forward equal to the reference's within 1 bf16 ulp of the largest
  output (tests/test_torch_ssm.py's bound);
* the train launcher on zamba2, xlstm, whisper (``frames``) and pixtral
  (``patches``): its logged losses equal, bit for bit, the step
  function's on the loader's batches in the same process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import global_rel, jax_flat, to_jax
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data.synthetic import batches_for
from repro.launch import steps as jsteps
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.optim import losses as jlosses
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.synthetic import DataCursor, ShardedLoader
from repro_torch.launch import train as launch_train
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.models.common import Builder
from repro_torch.optim import optimizers as topt
from repro_torch.optim.losses import lm_loss

# arch -> (accum, remat): remat on and accumulation over 2 microbatches
# each on at least one family
FAMILIES = {
    "gemma2-2b": (1, True),
    "gemma3-1b": (2, False),
    "yi-6b": (2, True),
    "deepseek-v2-lite-16b": (2, True),
    "zamba2-7b": (1, True),
    "xlstm-125m": (1, False),
}
MOE = {"deepseek-v2-lite-16b"}
STEPS = 1
KW = dict(lr=3e-4, total_steps=STEPS, warmup_steps=1)


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - w)
                 / np.linalg.norm(w))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_step_matches_reference(arch):
    accum, remat = FAMILIES[arch]
    moe = arch in MOE
    jcfg, cfg = _cfgs(arch)
    tp = TM.init_params(cfg, 0, device="cpu")
    jp0 = to_jax(tp)
    tp = tree.tree_map(torch.clone, tp)     # jp0 may share tp's memory
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt.AdamWConfig(**KW), accum=accum, remat=remat))
    tstep = tsteps.make_train_step(cfg, topt.AdamWConfig(**KW), accum=accum,
                                   remat=remat)
    jp, js = jp0, jopt.adamw_init(jp0)
    ts = topt.adamw_init(tp)
    for b in batches_for(jcfg, n=STEPS, batch=4, seq=32, split="train"):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp2, ts2, tm = tstep(tp, ts, b)
        assert tp2 is tp and ts2 is ts
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-2 if moe else 2e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=3e-2 if moe else 1e-2)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=2.0 ** -22)
    assert int(ts.count) == int(js.count) == STEPS
    rel = global_rel(jp, tp)
    upd = global_rel(jp, tp, base=jp0)
    moments = max(global_rel(js.mu, ts.mu), global_rel(js.nu, ts.nu))
    print(f"{arch} accum={accum} remat={remat}: last loss "
          f"{float(tm['loss']):.5f} vs {float(jm['loss']):.5f}, grad_norm "
          f"{float(tm['grad_norm']):.5f} vs {float(jm['grad_norm']):.5f}, "
          f"params {rel:.2e} (of the update {upd:.3f}), moments "
          f"{moments:.2e}")
    assert rel <= 2e-4 and upd <= (0.25 if moe else 0.12)
    assert moments <= (0.2 if moe else 2e-2)


def test_zamba2_shared_gradients_sum_over_invocations():
    """12 layers: two ``mamba_shared`` invocations of ``params["shared"]``,
    each with its own LoRA deltas; the gradient of each shared leaf is
    the sum over both, held leaf by leaf."""
    jcfg, cfg = _cfgs("zamba2-7b", num_layers=12)
    assert cfg.pattern.count("mamba_shared") == 1
    assert cfg.num_layers // len(cfg.pattern) == 2
    g = torch.Generator().manual_seed(1)
    # the LoRA ``b`` factors start at zero (so would every ``a`` gradient)
    tp = tree.map_with_path(
        lambda path, a: a + 0.02 * torch.randn(a.shape, generator=g)
        if "lora" in path and path.endswith("['b']") else a,
        TM.init_params(cfg, 0, device="cpu"))
    jp = to_jax(tp)
    b = batches_for(jcfg, n=1, batch=4, seq=32, split="train")[0]
    jg = jax.jit(jax.grad(lambda p, t: jlosses.lm_loss(
        jcfg, p, {"tokens": t}, remat=True)[0]))(jp, jnp.asarray(b["tokens"]))
    leaves = [x.detach().requires_grad_(True) for x in tree.leaves(tp)]
    W = tree.unflatten_like(tp, leaves)
    loss, _ = lm_loss(cfg, W, {"tokens": torch.from_numpy(b["tokens"])},
                      remat=True)
    tg = tree.unflatten_like(tp, list(torch.autograd.grad(loss, leaves)))
    want = {p: v for p, v in jax_flat(jg).items()
            if p.startswith("['shared']")}
    got = dict(tree.flatten_with_path(tg))
    assert len(want) >= 7, sorted(want)
    worst = 0.0
    for path, w in want.items():
        r = _rel(got[path], w)
        print(f"zamba2 grad {path}: {r:.2e}")
        assert r <= 0.1, (path, r)
        worst = max(worst, r)
    # the LoRA deltas of each invocation and the rest of the tree too
    lora = [p for p in got if "lora" in p]
    assert len(lora) == 6, sorted(got)
    flat_j = jax_flat(jg)
    for path in lora:
        r = _rel(got[path], flat_j[path])
        print(f"zamba2 grad {path}: {r:.2e}")
        assert r <= 0.1, (path, r)
    print(f"zamba2 shared leaves: worst {worst:.2e} over {len(want)}")


def test_slstm_layer_gradient_matches_reference_custom_vjp():
    """The whole sLSTM layer over 64 steps: autograd through the port's
    time loop against ``jax.grad`` through the reference's hand-written
    BPTT, for every param leaf and the input."""
    d, H, B, S = 64, 2, 2, 64
    g = torch.Generator().manual_seed(0)
    p = txl.slstm_init(Builder("init", g, "cpu"), d_model=d, num_heads=H)
    p = tree.map_with_path(
        lambda path, a: a + 0.1 * torch.randn(a.shape, generator=g)
        if path.endswith(("['scale']", "bias']")) else a, p)
    jp = to_jax(p)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    w = rng.standard_normal((B, S, d)).astype(np.float32)

    def jloss(p, x):
        y, _ = jxl.slstm_apply(p, x, None, num_heads=H)
        return jnp.sum(y.astype(jnp.float32) * w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [a.detach().requires_grad_(True) for a in tree.leaves(p)]
    tx = x.clone().requires_grad_(True)
    y, _ = txl.slstm_apply(tree.unflatten_like(p, leaves), tx, None,
                           num_heads=H)
    loss = (y.float() * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, leaves + [tx])
    got = dict(tree.flatten_with_path(
        tree.unflatten_like(p, list(grads[:-1]))))
    rels = {path: _rel(got[path], wv) for path, wv in jax_flat(jgp).items()}
    rels["x"] = _rel(grads[-1].float(), np.asarray(jgx, np.float32))
    print("sLSTM layer gradients:", {k: f"{v:.2e}" for k, v in rels.items()})
    assert len(rels) == len(leaves) + 1
    assert max(rels.values()) <= 2e-4, rels


def test_mamba2_gradient_finite_where_the_reference_overflows():
    """A decay steep enough that ``exp`` of the segment sums above the
    chunk's diagonal overflows: the reference's ``where(causal,
    exp(diff), 0)`` passes 0 * inf = NaN back; the port masks before the
    exp (R24)."""
    dims = dict(d_inner=128, d_state=16, head_dim=16)
    g = torch.Generator().manual_seed(0)
    p = tssm.mamba2_init(Builder("init", g, "cpu"), d_model=64, **dims)
    p["A_log"] = torch.full_like(p["A_log"], 4.0)
    p["dt_bias"] = torch.full_like(p["dt_bias"], 3.0)
    jp = to_jax(p)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 64)).astype(np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)

    def jloss(p, x):
        y, _ = jssm.mamba2_apply_full(p, x, chunk=16, **dims)
        return jnp.sum(y.astype(jnp.float32))

    jy = np.asarray(jax.jit(lambda p, x: jssm.mamba2_apply_full(
        p, x, chunk=16, **dims)[0])(jp, jx), np.float32)
    jg = jax.jit(jax.grad(jloss))(jp, jx)
    assert np.isnan(np.asarray(jg["A_log"])).any()
    leaves = [a.detach().requires_grad_(True) for a in tree.leaves(p)]
    y, _ = tssm.mamba2_apply_full(tree.unflatten_like(p, leaves), x,
                                  chunk=16, **dims)
    np.testing.assert_allclose(y.detach().float().numpy(), jy, rtol=0,
                               atol=2 ** -8 * np.abs(jy).max())
    grads = torch.autograd.grad(y.float().sum(), leaves)
    assert all(torch.isfinite(t).all() for t in grads)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m", "whisper-small",
                                  "pixtral-12b"])
def test_train_launcher_runs_and_logs_the_step_losses(arch, capsys):
    """``python -m repro_torch.launch.train --arch A --smoke --device cpu``:
    its printed losses are the step function's on the loader's batches
    (whisper's with ``frames``, pixtral's with ``patches``)."""
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "2",
                             "--batch", "2", "--seq", "32", "--log-every",
                             "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" loss ")[0] for ln in lines[:2]] == ["step 0", "step 1"]
    cfg = get_smoke_config(arch)
    ocfg = topt.AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=1)
    params = TM.init_params(cfg, 0, device="cpu")
    ostate = topt.adamw_init(params)
    step = tsteps.make_train_step(cfg, ocfg, remat=True)
    loader = ShardedLoader(cfg, global_batch=2, seq=32,
                           cursor=DataCursor(index=0))
    want = []
    for _ in range(2):
        b = next(loader)
        assert {"frames": cfg.is_encoder_decoder,
                "patches": bool(cfg.vit_dim)} == {
            k: k in b for k in ("frames", "patches")}
        params, ostate, m = step(params, ostate, b)
        want.append(float(m["loss"]))
    assert [row[1] for row in out["log"]] == want
    for ln, w in zip(lines, want):
        assert f"loss {w:.4f} " in ln
