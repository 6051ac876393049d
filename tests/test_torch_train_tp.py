"""Training over gloo ranks on the CPU: the train step and AdamW on each
rank's blocks, checkpoints on a mesh, the train launcher's --model-axis
and the straggler's recovered mesh, held against the port's
single-process train step (tests/test_torch_train.py holds that one
against the reference's jitted step; the reference's own train launcher
fails on jax 0.9, ROADMAP R13) and, for the checkpoints, against the
reference's ``CheckpointManager``.

One spawn of 4 ranks (``repro_torch.dist.ranks.run_ranks``; each rank runs
``_torch_train_ranks.rank_main``, which imports no jax) runs every case:

* smoke llama3.2-1b on meshes (1, 4), (2, 2) (accum 2, bf16 cast) and
  (4, 1), smoke mixtral-8x22b on (1, 4) and (2, 2): 2 AdamW steps of 4 x
  32 tokens with remat;
* the (1, 4) llama state checkpointed by the ranks, restored onto (2, 2)
  and into one process, a step taken on each; a checkpoint the reference
  wrote restored onto (2, 2);
* the train launcher over the 4 ranks: straight on (1, 4), then on (2, 2)
  dying after its step-2 checkpoint, resumed on (1, 4);
* a (2, 2) checkpoint resumed after rank 3 fails, on the mesh
  ``ckpt.straggler.plan_recovery`` gives the survivors;
* a remat backward on another thread than its forward.

Held, bit for bit: params, mu, nu and count gathered after the steps, the
loss and grad_norm of every step on every rank (the global norm takes
each sharded gradient whole, as one process does: ROADMAP R28), a resume
against one process's, the launcher's logs against one process's; each
rank's params + mu + nu bytes against ``params_sharding``'s blocks.
Mixtral on (2, 2) splits its MoE dispatch into the mesh's two "batch"
groups (ROADMAP R26), so it is held against one process running with
the same two groups (rules over a layout-only (2, 2) mesh, no block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_ranks as R
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.ckpt import straggler
from repro_torch.ckpt.checkpoint import CheckpointManager, flatten_state
from repro_torch.configs.base import ARCH_IDS, get_smoke_config
from repro_torch.dist import ranks
from repro_torch.dist import sharding as shd
from repro_torch.dist.axes import make_rules
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.common import Builder
from repro_torch.optim import optimizers as opt

WORLD = 4
CASES = [c[0] for c in R.CASES]
SPEC = {c[0]: c[1:] for c in R.CASES}
OTHER_FAMILIES = ("yi-6b", "gemma2-2b", "gemma3-1b", "deepseek-v2-lite-16b",
                  "zamba2-7b", "xlstm-125m", "whisper-small", "pixtral-12b")


def _flat(state) -> dict:
    return {p: x.numpy() for p, x in flatten_state(state)}


def _single(model, shape, accum, cast_bf16):
    """One process's STEPS steps: (params, ostate, metrics).  Mixtral on a
    mesh with "data" 2 dispatches in two groups, as its ranks do (rules
    over a layout-only mesh: no block, no collective)."""
    cfg = get_smoke_config(R.ARCHS[model])
    rules = (make_rules(Mesh(shape, R.AXES, rank=0))
             if model == "mixtral" and shape[0] > 1 else None)
    params = M.init_params(cfg, 0, device="cpu")
    return R.train(cfg, rules, R.batches(cfg)[:R.STEPS], accum=accum,
                   cast_bf16=cast_bf16,
                   state=(params, opt.adamw_init(params)))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_tp")
    return {k: str(d / k) for k in ("ranked", "reference", "launcher",
                                    "straggler")}


@pytest.fixture(scope="module")
def single():
    """Each case's single-process run."""
    return {name: _single(*SPEC[name]) for name in CASES}


@pytest.fixture(scope="module")
def reference_ckpt(dirs, single):
    """The reference's ``CheckpointManager`` writes llama 1x4's
    single-process state (as jax arrays) at step 2."""
    params, ostate, _ = single["llama 1x4"]
    jstate = (jax.tree.map(jnp.asarray, tree.tree_map(
        lambda x: x.numpy(), params)),
        jopt.AdamWState(mu=jax.tree.map(jnp.asarray, tree.tree_map(
            lambda x: x.numpy(), ostate.mu)),
            nu=jax.tree.map(jnp.asarray, tree.tree_map(
                lambda x: x.numpy(), ostate.nu)),
            count=jnp.int32(int(ostate.count))))
    JaxCheckpointManager(dirs["reference"]).save(
        R.STEPS, jstate, metadata={"next_step": R.STEPS})
    return jstate


@pytest.fixture(scope="module")
def ranked(dirs, reference_ckpt):
    """Every rank's results of ``rank_main`` (one spawn for the module)."""
    return ranks.run_ranks(R.rank_main, WORLD, args=(dirs,), timeout=120.0,
                           deadline=600.0)


def _one_more_step(state, next_step, accum=1):
    """One process's step from ``state`` on llama's batch ``next_step``."""
    cfg = get_smoke_config(R.ARCHS["llama"])
    return R.train(cfg, None, R.batches(cfg)[next_step:][:1], accum=accum,
                   state=state)


def _restored(ckpt_dir):
    """A llama checkpoint restored into one process."""
    cfg = get_smoke_config(R.ARCHS["llama"])
    p = M.empty_params(cfg, device="cpu")
    return CheckpointManager(ckpt_dir).restore((p, opt.adamw_init(p)))


def _assert_state_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("case", CASES)
def test_state_matches_single_process(ranked, single, case):
    """params, mu, nu and count gathered on rank 0 after 2 steps equal the
    single process's bit for bit."""
    params, ostate, _ = single[case]
    got = ranked[0][case]["state"]
    _assert_state_equal(got, _flat((params, ostate)))
    assert int(got["[1].count"]) == R.STEPS
    assert ranked[0][case]["blocked"] >= 8       # the sharded leaves
    for r in ranked[1:]:
        assert r[case]["state"] is None           # whole on rank 0 only


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grad_norm_match_single_process(ranked, single, case):
    """Every step's loss and grad_norm, on every rank, equal one
    process's."""
    want = single[case][2]
    assert len(want) == R.STEPS
    for r in ranked:
        assert r[case]["metrics"] == want, case


@pytest.mark.parametrize("case", CASES)
def test_state_bytes_are_the_blocks(ranked, case):
    """Each rank's params + mu + nu storages hold its blocks and nothing
    more: three f32 copies of ``params_sharding``'s blocks."""
    cfg = get_smoke_config(R.ARCHS[SPEC[case][0]])
    whole = 3 * 4 * sum(x.numel() for x in tree.leaves(
        M.init_params(cfg, 0, device="cpu")))
    for r in ranked:
        assert r[case]["bytes"] == r[case]["planned"], case
        assert r[case]["bytes"] < whole


def test_checkpoint_restores_onto_another_mesh(ranked, single):
    """The ranks' (1, 4) checkpoint restored onto (2, 2): one more step
    there equals one more step of one process from its own state, bit
    for bit (restoring only moves data)."""
    got = ranked[0]["restore 2x2"]
    assert got["meta"] == {"next_step": R.STEPS}
    params, ostate, _ = single["llama 1x4"]
    # the step updates in place: one process steps from copies
    copy = lambda t: tree.tree_map(torch.clone, t)  # noqa: E731
    p, o, metrics = _one_more_step((copy(params), opt.AdamWState(
        mu=copy(ostate.mu), nu=copy(ostate.nu), count=ostate.count.clone())),
        R.STEPS)
    for r in ranked:
        assert r["restore 2x2"]["metrics"] == metrics
    _assert_state_equal(got["state"], _flat((p, o)))


def test_checkpoint_restores_into_one_process(ranked, dirs):
    """The ranks' checkpoint restored into one process is the state the
    ranks gathered; one step from it equals the ranks' step from it on
    (2, 2)."""
    (p, o), meta = _restored(dirs["ranked"])
    assert meta == {"next_step": R.STEPS}
    _assert_state_equal(_flat((p, o)), ranked[0]["llama 1x4"]["state"])
    p, o, metrics = _one_more_step((p, o), meta["next_step"])
    assert ranked[0]["restore 2x2"]["metrics"] == metrics
    _assert_state_equal(ranked[0]["restore 2x2"]["state"], _flat((p, o)))


def test_reference_checkpoint_restores_onto_the_ranks(ranked,
                                                      reference_ckpt):
    """A checkpoint the reference's ``CheckpointManager`` wrote, restored
    onto (2, 2): each rank's block is its slice of the reference's leaf,
    under ``params_sharding``'s spec (mu and nu their parameter's)."""
    from _torch_port import jax_flat
    want = {p: np.asarray(x) for p, x in jax_flat(reference_ckpt).items()}
    cfg = get_smoke_config(R.ARCHS["llama"])
    specs = dict(tree.flatten_with_path(shd.params_sharding(
        M.param_axes(cfg), M.param_shapes(cfg), make_rules(
            Mesh((2, 2), R.AXES, rank=0)))))
    for rank, r in enumerate(ranked):
        mesh = Mesh((2, 2), R.AXES, rank=rank)
        got = r["reference 2x2"]["blocks"]
        assert list(got) == list(want)
        for path, w in want.items():
            # "[0]<p>", "[1].mu<p>" and "[1].nu<p>" take <p>'s spec
            spec = specs.get(path[3:] if path.startswith("[0]")
                             else path[len("[1].mu"):])
            blk = w if spec is None else shd.local_block(
                torch.from_numpy(w.copy()), spec, mesh).numpy()
            np.testing.assert_array_equal(got[path], blk, err_msg=path)


def test_ranks_checkpoint_restores_in_the_reference(ranked, dirs,
                                                    reference_ckpt):
    """The ranks' checkpoint read by the reference's ``restore`` gives the
    arrays the ranks gathered."""
    from _torch_port import jax_flat
    (rp, rs), meta = JaxCheckpointManager(dirs["ranked"]).restore(
        reference_ckpt)
    assert meta == {"next_step": R.STEPS}
    assert isinstance(rs, jopt.AdamWState)
    got = {p: np.asarray(x) for p, x in jax_flat((rp, rs)).items()}
    _assert_state_equal(got, ranked[0]["llama 1x4"]["state"])


def test_launcher_over_ranks_logs_one_process(ranked, capsys):
    """``launch.train --model-axis 4`` over the 4 ranks logs one process's
    losses and grad norms bit for bit."""
    want = launch_train.main(R.LAUNCH_ARGS)
    capsys.readouterr()
    got = ranked[0]["launcher"]["straight"]
    assert [x[:3] for x in got] == [x[:3] for x in want["log"]]
    assert [x[0] for x in got] == [0, 1, 2, 3]


def test_launcher_resumes_on_another_mesh(ranked, capsys):
    """The launcher's checkpoint from (2, 2) (written at step 2, the run
    dead at step 3) resumes on (1, 4): its steps and its final state are
    one process's straight run's, bit for bit."""
    want = launch_train.main(R.LAUNCH_ARGS)
    capsys.readouterr()
    got = ranked[0]["launcher"]
    assert [x[:3] for x in got["resumed"]] == \
        [x[:3] for x in want["log"][2:]]
    _assert_state_equal(got["state"], _flat((want["params"],
                                             want["ostate"])))
    assert got["steps"] == [2, 4]


def test_straggler_recovered_mesh_resume(ranked, dirs, single):
    """Rank 3 of a (2, 2) mesh fails: the plan keeps the model axis, (1,
    2) over hosts 0 and 1 with accum x 2; ``straggler.resume`` restores
    the checkpoint onto that mesh (ranks 2 and 3 idle) and its step
    equals one process's resume at accum 2, bit for bit."""
    for rank, r in enumerate(ranked):
        got = r["straggler"]
        assert got["plan"] == ((1, 2), (0, 1), 2)
        assert got["member"] == (rank < 2)
    got = ranked[0]["straggler"]
    assert got["accum"] == 2 and got["next_step"] == R.STEPS
    assert got["mesh"] == {"data": 1, "model": 2}
    (p, o), meta = _restored(dirs["straggler"])
    _assert_state_equal(_flat((p, o)), _flat(single["llama 1x4"][:2]))
    p, o, metrics = _one_more_step((p, o), meta["next_step"], accum=2)
    assert got["metrics"] == metrics
    assert ranked[1]["straggler"]["metrics"] == metrics
    _assert_state_equal(got["state"], _flat((p, o)))


def test_remat_recompute_off_the_forward_thread(ranked):
    """Under remat the layers recompute in the backward, on the thread
    that runs it (on the card, autograd's device thread): with the
    forward's rules and whole weights, the same gradients as a backward
    on the forward's thread."""
    for r in ranked:
        assert r["remat thread"]["error"] is None, r["remat thread"]
        assert r["remat thread"]["equal"]


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_refused_under_rules(arch):
    """A family outside llama and mixtral raises before any collective,
    naming the ROADMAP item."""
    rules = make_rules(Mesh((1, WORLD), R.AXES, rank=0))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
        make_train_step(get_smoke_config(arch), R.ocfg(), rules=rules)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_draws_in_the_builders_order(arch):
    """``init_params`` draws ``param_specs`` in the tree's insertion
    order: the values ``Builder("init")`` draws leaf by leaf as it builds
    the tree (the block inits' tests build theirs so)."""
    cfg = get_smoke_config(arch)
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    want = tree.flatten_with_path(M._build(cfg, Builder("init", g, "cpu")))
    got = tree.flatten_with_path(M.init_params(cfg, 5, device="cpu"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, w) in zip(got, want):
        assert x.dtype == w.dtype, path
        assert torch.equal(x, w), path


@pytest.mark.parametrize("model", sorted(R.ARCHS))
def test_empty_params_are_the_init_blocks_layout(model):
    """``empty_params(rules=)``, the restore template, has each rank's
    blocks of ``init_params(rules=)``: the same leaves, shapes, dtypes and
    specs on every rank of (2, 2), with no value drawn."""
    cfg = get_smoke_config(R.ARCHS[model])
    for rank in range(WORLD):
        rules = make_rules(Mesh((2, 2), R.AXES, rank=rank))
        want = tree.flatten_with_path(M.init_params(cfg, 0, device="cpu",
                                                    rules=rules))
        got = tree.flatten_with_path(M.empty_params(cfg, device="cpu",
                                                    rules=rules))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, x), (_, w) in zip(got, want):
            assert type(x) is type(w), path
            assert (x.shape, x.dtype) == (w.shape, w.dtype), path
            if isinstance(w, shd.DenseBlock):
                assert x.spec == w.spec, path


@pytest.mark.parametrize("surviving,chips,old_mesh,shape,ranks_", [
    ((0, 1, 2), 1, (2, 2), (1, 2), (0, 1)),
    ((0, 2, 3), 4, (4, 4), (2, 4), (0, 1, 2, 3, 8, 9, 10, 11)),
    ((1, 3), 2, (4, 2), (2, 2), (2, 3, 6, 7)),
])
def test_recovered_mesh_takes_the_plans_hosts(surviving, chips, old_mesh,
                                              shape, ranks_):
    """The recovered mesh lays the plan's mesh over its hosts' ranks,
    each host's chips counted from the plan itself (this process, rank 0
    of no group, is a member where host 0 survives)."""
    plan = straggler.plan_recovery(surviving, hosts_total=4,
                                   old_mesh=old_mesh, model_axis=shape[1],
                                   chips_per_host=chips)
    assert plan.mesh_shape == shape
    mesh = straggler.recovered_mesh(plan)
    assert mesh.ranks == ranks_
    assert mesh.member == (0 in ranks_)


def test_recovered_mesh_refuses_a_plan_of_partial_hosts():
    """A plan whose mesh does not fill whole hosts has no rank layout."""
    for hosts, shape in (((), (1, 2)), ((0, 1), (1, 3))):
        plan = straggler.RecoveryPlan(mesh_shape=shape, hosts=hosts,
                                      accum_scale=1, dropped_hosts=())
        with pytest.raises(ValueError):
            straggler.recovered_mesh(plan)

