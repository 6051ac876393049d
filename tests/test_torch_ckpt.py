"""repro_torch's checkpoints and straggler policy: the port's twins of
tests/test_ckpt.py's tests, then checkpoints across packages in both
directions (the reference's ``CheckpointManager`` writes ``(params,
AdamWState)`` and the port restores the same bytes, and the reverse).
Every comparison is exact: a checkpoint stores the leaves' bytes."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_port import jax_flat, jax_params_to_torch
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.optim import optimizers as jopt
from repro_torch import tree as ttree
from repro_torch.ckpt.checkpoint import CheckpointManager, flatten_state
from repro_torch.ckpt.straggler import HeartbeatMonitor, plan_recovery
from repro_torch.optim import optimizers as topt



def tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"mu": torch.ones((5,)), "count": torch.tensor(3)},
            "none": None}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = tree()
    mgr.save(7, state, metadata={"next_step": 7})
    out, meta = mgr.restore(state)
    assert meta["next_step"] == 7
    assert torch.equal(out["w"], state["w"])
    assert torch.equal(out["opt"]["mu"], state["opt"]["mu"])
    assert torch.equal(out["opt"]["count"], state["opt"]["count"])
    assert out["none"] is None


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in [1, 2, 3]:
        mgr.save_async(s, tree())
    mgr.wait()
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]  # keep=2 garbage-collects step 1


def test_torn_save_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree())
    # simulate a crash mid-save: stray tmp dir
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "junk.npy").write_bytes(b"xx")
    assert mgr.latest_step() == 1
    out, _ = mgr.restore(tree())
    assert torch.equal(out["w"], torch.arange(12.0).reshape(3, 4))


def test_resave_same_step(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, tree())
    mgr.save(5, tree())  # periodic + final save collision must not raise
    assert mgr.latest_step() == 5


def test_restore_onto_a_device(tmp_path):
    """Each leaf lands on its template leaf's device (the port's
    counterpart of the reference's restore with target shardings); a
    template leaf that is not a tensor gives a CPU tensor."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree())
    template = tree()
    template["w"] = np.zeros((3, 4))
    out, _ = mgr.restore(template)
    for path, x in ttree.flatten_with_path(out):
        assert x is None or x.device.type == "cpu", path
    assert torch.equal(out["w"], tree()["w"])
    assert out["opt"]["count"].dtype == torch.int64


def test_save_async_snapshots_before_returning(tmp_path):
    """An in-place update right after ``save_async`` returns never reaches
    the saved bytes."""
    mgr = CheckpointManager(tmp_path)
    state = {"w": torch.zeros(1000, 64)}
    mgr.save_async(1, state)
    state["w"].add_(1.0)
    mgr.wait()
    out, _ = mgr.restore(state)
    assert not out["w"].any() and bool((state["w"] == 1).all())


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CheckpointManager(tmp_path).restore(tree())


# --- straggler / recovery ---------------------------------------------------

def test_heartbeat_failure_detection():
    mon = HeartbeatMonitor(4, timeout_s=10)
    for h in range(4):
        mon.beat(h, step=1, now=100.0, step_s=1.0)
    mon.beat(0, step=2, now=105.0, step_s=1.0)
    assert mon.failed(now=112.0) == [1, 2, 3]
    assert mon.failed(now=106.0) == []


def test_straggler_detection():
    mon = HeartbeatMonitor(4, straggler_factor=2.0)
    times = [1.0, 1.1, 0.9, 5.0]
    for h, t in enumerate(times):
        for s in range(5):
            mon.beat(h, step=s, now=float(s), step_s=t)
    assert mon.stragglers() == [3]
    assert 3 not in mon.healthy(now=4.0)


@settings(max_examples=25, deadline=None)
@given(n_fail=st.integers(0, 48), model_axis=st.sampled_from([8, 16]))
def test_recovery_plan_valid(n_fail, model_axis):
    from repro.ckpt.straggler import plan_recovery as jax_plan_recovery
    hosts_total = 64
    chips = 4
    surviving = list(range(hosts_total - n_fail))
    if len(surviving) * chips < model_axis:
        return
    kw = dict(hosts_total=hosts_total,
              old_mesh=(hosts_total * chips // model_axis, model_axis),
              model_axis=model_axis, chips_per_host=chips)
    plan = plan_recovery(surviving, **kw)
    data, model = plan.mesh_shape
    assert model == model_axis
    assert data * model <= len(surviving) * chips
    old_data = hosts_total * chips // model_axis
    assert old_data % data == 0
    assert plan.accum_scale == old_data // data  # global batch preserved
    assert set(plan.hosts) <= set(surviving)
    want = jax_plan_recovery(surviving, **kw)   # the reference's plan
    assert (plan.mesh_shape, plan.hosts, plan.accum_scale,
            plan.dropped_hosts) == (want.mesh_shape, want.hosts,
                                    want.accum_scale, want.dropped_hosts)


def test_recovery_plan_refuses_too_few_chips():
    with pytest.raises(ValueError, match="one TP group"):
        plan_recovery([0], hosts_total=4, old_mesh=(2, 8), model_axis=8)


# --- across packages ---------------------------------------------------------

@pytest.fixture(scope="module")
def train_state():
    """(params, AdamWState) of smoke llama3.2-1b with nonzero moments and
    count, in both packages."""
    cfg = jax_smoke_config("llama3.2-1b")
    jp = JM.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    noise = lambda: jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jp)
    js = jopt.AdamWState(mu=noise(), nu=jax.tree.map(jnp.abs, noise()),
                         count=jnp.int32(17))
    ts = topt.AdamWState(mu=jax_params_to_torch(js.mu),
                         nu=jax_params_to_torch(js.nu),
                         count=torch.tensor(17, dtype=torch.int32))
    return (jp, js), (jax_params_to_torch(jp), ts)


def _assert_same(jstate, tstate):
    """Same keystr paths in the same order, every leaf's bytes equal."""
    jf = jax_flat(jstate)
    tf = flatten_state(tstate)
    assert list(jf) == [p for p, _ in tf]
    for (path, t), j in zip(tf, jf.values()):
        j = np.asarray(j)
        assert isinstance(t, torch.Tensor), path
        assert t.numpy().dtype == j.dtype and t.shape == j.shape, path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


def test_reference_checkpoint_restores_in_the_port(tmp_path, train_state):
    (jp, js), template = train_state
    JaxCheckpointManager(tmp_path).save(
        12, (jp, js), metadata={"next_step": 12})
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 12
    (tp, ts), meta = mgr.restore(template)
    assert meta == {"next_step": 12}
    assert isinstance(ts, topt.AdamWState)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 17
    _assert_same((jp, js), (tp, ts))


def test_port_checkpoint_restores_in_the_reference(tmp_path, train_state):
    (jp, js), tstate = train_state
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(9, tstate, metadata={"next_step": 9})
    mgr.close()
    manifest = json.loads((tmp_path / "step_00000009" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 9
    assert "[1].count" in manifest["leaves"]
    assert "[0]['embed']['table']" in manifest["leaves"]
    (rp, rs), meta = JaxCheckpointManager(tmp_path).restore((jp, js))
    assert meta == {"next_step": 9}
    assert isinstance(rs, jopt.AdamWState)
    _assert_same((rp, rs), tstate)
