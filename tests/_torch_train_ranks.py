"""The rank side of tests/test_torch_train_tp.py: what each gloo rank
computes.

Spawned ranks import this module and the port only (no jax, no test
module).  Every input is drawn from a seed (the port's ``init_params``,
the synthetic corpus), so each rank and the test process build the same
params and batches.
"""
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.ckpt import straggler
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.synthetic import ShardedLoader, batches_for
from repro_torch.dist import sharding as shd
from repro_torch.dist.axes import make_rules, use_rules
from repro_torch.kernels.shard import whole_weights
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.optim.losses import lm_loss

AXES = ("data", "model")
ARCHS = {"llama": "llama3.2-1b", "mixtral": "mixtral-8x22b"}
STEPS, ROWS, SEQ = 2, 4, 32
# (case, model, mesh, accum, cast_bf16)
CASES = (("llama 1x4", "llama", (1, 4), 1, False),
         ("llama 2x2", "llama", (2, 2), 2, True),
         ("llama 4x1", "llama", (4, 1), 1, False),
         ("mixtral 1x4", "mixtral", (1, 4), 1, False),
         ("mixtral 2x2", "mixtral", (2, 2), 1, False))
LAUNCH_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--seq",
               "32", "--log-every", "1", "--steps", "4", "--device", "cpu"]
# the survivors of a (2, 2) mesh of 4 one-rank hosts whose rank 3 failed
RECOVERY = dict(surviving=(0, 1, 2), hosts_total=4, old_mesh=(2, 2),
                model_axis=2, chips_per_host=1)


class Died(Exception):
    """The job dies (a lost host, a preemption)."""


def ocfg() -> opt.AdamWConfig:
    """The train launcher's schedule for STEPS steps."""
    return opt.AdamWConfig(lr=3e-4, total_steps=STEPS, warmup_steps=1)


def batches(cfg, n: int = STEPS + 1) -> list:
    """The train split's first ``n`` batches of ROWS x SEQ."""
    return batches_for(cfg, n=n, batch=ROWS, seq=SEQ, split="train")


def train(cfg, rules, steps_batches, *, accum=1, cast_bf16=False,
          state=None):
    """``make_train_step`` over the batches from ``state`` (default: the
    init, placed under ``rules``): (params, ostate, [(loss, grad_norm)])."""
    if state is None:
        params = M.init_params(cfg, 0, device="cpu", rules=rules)
        state = (params, opt.adamw_init(params))
    params, ostate = state
    step = make_train_step(cfg, ocfg(), accum=accum, remat=True,
                           cast_bf16=cast_bf16, rules=rules)
    metrics = []
    for b in steps_batches:
        params, ostate, m = step(params, ostate, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params, ostate, metrics


def gathered(state, mesh) -> dict | None:
    """{keystr path: numpy leaf} of ``(params, AdamWState)``, each block
    gathered whole (every rank takes part), on rank 0; None elsewhere."""
    from repro_torch.ckpt.checkpoint import flatten_state
    out = {}
    for path, x in flatten_state(state):
        x = shd.whole(x, mesh)
        if mesh.rank == 0:
            out[path] = x.cpu().numpy().copy()
    return out if mesh.rank == 0 else None


def blocks(state) -> dict:
    """{keystr path: numpy block} of this rank's ``(params, AdamWState)``."""
    from repro_torch.ckpt.checkpoint import flatten_state
    return {p: shd.block_data(x).numpy().copy()
            for p, x in flatten_state(state)}


def held_bytes(params, ostate) -> int:
    """Bytes of this rank's params, mu and nu storages."""
    return sum(shd.block_data(x).untyped_storage().nbytes()
               for t in (params, ostate.mu, ostate.nu)
               for x in tree.leaves(t))


def planned_bytes(cfg, rules) -> int:
    """This rank's params + mu + nu bytes by ``params_sharding``'s spec
    tree alone: three f32 blocks of every leaf."""
    shapes = M.param_shapes(cfg)
    specs = shd.params_sharding(M.param_axes(cfg), shapes, rules)
    return 3 * sum(4 * int(np.prod(shd.block_shape(s, spec, rules.mesh)))
                   for s, spec in zip(tree.leaves(shapes),
                                      tree.leaves(specs), strict=True))


def train_case(model, shape, accum, cast_bf16, ckpt_dir=None) -> dict:
    """STEPS steps on ``shape``: every rank's metrics and bytes, the whole
    state on rank 0; with ``ckpt_dir`` the state is also saved there (the
    launcher's path: gathered, rank 0 writes, a barrier)."""
    cfg = get_smoke_config(ARCHS[model])
    mesh = Mesh(shape, AXES)
    rules = make_rules(mesh)
    params, ostate, metrics = train(cfg, rules, batches(cfg)[:STEPS],
                                    accum=accum, cast_bf16=cast_bf16)
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(STEPS, (params, ostate), metadata={"next_step": STEPS},
                 rules=rules)
        mgr.close()
    return {"metrics": metrics, "bytes": held_bytes(params, ostate),
            "planned": planned_bytes(cfg, rules),
            "blocked": sum(isinstance(x, shd.DenseBlock)
                           for x in tree.leaves(params)),
            "state": gathered((params, ostate), mesh)}


def restore_case(ckpt_dir, shape) -> dict:
    """Restore a llama checkpoint onto ``shape`` (a template of empty
    blocks) and take one more step on the next batch: this rank's
    restored blocks, the step's metrics, the state after it on rank 0."""
    cfg = get_smoke_config(ARCHS["llama"])
    mesh = Mesh(shape, AXES)
    rules = make_rules(mesh)
    template = M.empty_params(cfg, device="cpu", rules=rules)
    (params, ostate), meta = CheckpointManager(ckpt_dir).restore(
        (template, opt.adamw_init(template)), rules=rules)
    out = {"blocks": blocks((params, ostate)), "meta": meta}
    params, ostate, out["metrics"] = train(
        cfg, rules, batches(cfg)[meta["next_step"]:][:1],
        state=(params, ostate))
    out["state"] = gathered((params, ostate), mesh)
    return out


def launcher_case(ckpt_dir) -> dict:
    """The train launcher over the 4 ranks: 4 steps straight on (1, 4);
    then on (2, 2) with a checkpoint every 2 steps, dying as it fetches
    step 3's batch; then resumed from it on (1, 4).  Rank 0's logs and
    the resumed final state gathered."""
    straight = launch_train.main(LAUNCH_ARGS + ["--model-axis", "4"])
    next_batch = ShardedLoader.__next__

    def dying(loader):
        if loader.cursor.index == 3:
            raise Died
        return next_batch(loader)

    ShardedLoader.__next__ = dying
    try:
        launch_train.main(LAUNCH_ARGS + ["--model-axis", "2", "--ckpt-dir",
                                         ckpt_dir, "--ckpt-every", "2"])
    except Died:
        pass
    finally:
        ShardedLoader.__next__ = next_batch
    dist.barrier()       # the job is over: every rank sees its commit
    resumed = launch_train.main(LAUNCH_ARGS + ["--model-axis", "4",
                                               "--ckpt-dir", ckpt_dir])
    mesh = Mesh((1, 4), AXES)
    return {"straight": straight["log"], "resumed": resumed["log"],
            "state": gathered((resumed["params"], resumed["ostate"]), mesh),
            "steps": CheckpointManager(ckpt_dir).all_steps()}


def remat_thread_case() -> dict:
    """The layers' recomputation under remat runs where the backward runs
    (on the card, autograd's device thread, where the forward's rules and
    ``whole_weights`` are not installed): the forward here under the
    rules, the backward on another thread; its gradients against the
    backward on this thread."""
    cfg = get_smoke_config(ARCHS["llama"])
    rules = make_rules(Mesh((1, 4), AXES))
    params = M.init_params(cfg, 0, device="cpu", rules=rules)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    flat = tree.leaves(params)

    def grads(off_thread: bool) -> list:
        leaves = [shd.block_data(p).detach().requires_grad_(True)
                  for p in flat]
        w = tree.unflatten_like(params, [shd.like_block(p, x)
                                         for p, x in zip(flat, leaves)])
        with torch.enable_grad(), use_rules(rules), whole_weights():
            loss, _ = lm_loss(cfg, w, b, remat=True)
        out = {}

        def backward():
            try:
                out["g"] = torch.autograd.grad(loss, leaves)
            except Exception as e:        # noqa: BLE001 - reported
                out["err"] = repr(e)

        if off_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        if "err" in out:
            return out["err"]
        return [g.numpy().copy() for g in out["g"]]

    here, there = grads(False), grads(True)
    return {"error": there if isinstance(there, str) else None,
            "equal": not isinstance(there, str) and all(
                np.array_equal(a, b) for a, b in zip(here, there))}


def straggler_case(ckpt_dir) -> dict:
    """llama trained STEPS steps on (2, 2) and checkpointed; then rank 3
    fails: ``plan_recovery`` over the survivors, ``straggler.resume`` onto
    its mesh (ranks 0 and 1; 2 and 3 stand idle) with the accumulation
    scaled, one more step there, the state gathered on rank 0."""
    train_case("llama", (2, 2), 1, False, ckpt_dir)
    plan = straggler.plan_recovery(
        RECOVERY["surviving"], hosts_total=RECOVERY["hosts_total"],
        old_mesh=RECOVERY["old_mesh"], model_axis=RECOVERY["model_axis"],
        chips_per_host=RECOVERY["chips_per_host"])
    r = straggler.resume(plan, CheckpointManager(ckpt_dir),
                         get_smoke_config(ARCHS["llama"]), accum=1,
                         device="cpu")
    out = {"plan": (plan.mesh_shape, plan.hosts, plan.accum_scale),
           "member": r is not None}
    if r is not None:
        cfg = get_smoke_config(ARCHS["llama"])
        params, ostate, out["metrics"] = train(
            cfg, r.rules, batches(cfg)[r.next_step:][:1], accum=r.accum,
            state=(r.params, r.ostate))
        out.update(accum=r.accum, next_step=r.next_step,
                   mesh=dict(r.rules.mesh.shape),
                   state=gathered((params, ostate), r.rules.mesh))
    dist.barrier()        # the idle ranks wait for the survivors' step
    return out


def rank_main(rank: int, world: int, device, dirs: dict) -> dict:
    """Everything the test holds, from one rank."""
    out = {name: train_case(model, shape, accum, cast,
                            dirs["ranked"] if name == "llama 1x4" else None)
           for name, model, shape, accum, cast in CASES}
    out["restore 2x2"] = restore_case(dirs["ranked"], (2, 2))
    out["reference 2x2"] = restore_case(dirs["reference"], (2, 2))
    out["launcher"] = launcher_case(dirs["launcher"])
    out["remat thread"] = remat_thread_case()
    out["straggler"] = straggler_case(dirs["straggler"])
    return out


def card_rank(rank: int, world: int, device) -> dict:
    """tests/test_torch_cuda.py: smoke llama's STEPS steps with remat on
    (1, world) on this rank's card over gloo (the recomputation on
    autograd's device thread): the metrics on every rank, the whole state
    on rank 0 (numpy)."""
    cfg = get_smoke_config(ARCHS["llama"])
    mesh = Mesh((1, world), AXES)
    rules = make_rules(mesh)
    params = M.init_params(cfg, 0, device=device, rules=rules)
    params, ostate, metrics = train(
        cfg, rules, batches(cfg)[:STEPS],
        state=(params, opt.adamw_init(params)))
    return {"metrics": metrics, "state": gathered((params, ostate), mesh)}
