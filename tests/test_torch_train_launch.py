"""repro_torch's sharded loader and train launcher.

The loader's batches equal the reference's ``ShardedLoader``'s token for
token, across hosts and on cursor resume.  The launcher prints the
reference's log lines, checkpoints and resumes (a resumed run's steps equal
a straight run's, bit for bit on the CPU), refuses to run without a card
unless asked for the CPU, and refuses ``--model-axis`` > 1 without a
process group (tests/test_torch_train_tp.py runs it over ranks).  (The
reference's own launcher fails on jax 0.9 with the production sharding
rules in the embedding gather, ROADMAP R13, so its line format is taken
from its source.)"""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data.synthetic import DataCursor as JaxDataCursor
from repro.data.synthetic import ShardedLoader as JaxShardedLoader
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataCursor, ShardedLoader
from repro_torch.launch import train as launch_train


FIELDS = dict(name="t", family="dense", d_model=32, num_layers=1,
              num_heads=1, num_kv_heads=1, head_dim=32, d_ff=64,
              vocab_size=512)
CFG, JCFG = ModelConfig(**FIELDS), JaxModelConfig(**FIELDS)
SMOKE = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--seq", "32",
         "--log-every", "1", "--device", "cpu"]
class Died(Exception):
    """The job dies (a lost host, a preemption)."""


LINE = re.compile(r"^step (\d+) loss (\d+\.\d{4}) gnorm (\d+\.\d{3}) "
                  r"\((\d+\.\d)s\)$")


@settings(max_examples=10, deadline=None)
@given(num_hosts=st.sampled_from([1, 2, 4]), start=st.integers(0, 5))
def test_loader_matches_reference_across_hosts_and_resume(num_hosts, start):
    for h in range(num_hosts):
        kw = dict(global_batch=8, seq=16, host_id=h, num_hosts=num_hosts)
        ours = ShardedLoader(CFG, cursor=DataCursor(index=start), **kw)
        ref = JaxShardedLoader(JCFG, cursor=JaxDataCursor(index=start), **kw)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert set(a) == set(b) == {"tokens"}
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert ours.cursor.index == ref.cursor.index == start + 3


def test_loader_resume_equivalence_and_partition():
    """The reference's own loader properties on the port: a cursor at 3
    yields the 4th batch; the hosts' rows partition the global batch; a
    batch the hosts cannot split raises."""
    l1 = ShardedLoader(CFG, global_batch=4, seq=32)
    batches = [next(l1) for _ in range(5)]
    l2 = ShardedLoader(CFG, global_batch=4, seq=32,
                       cursor=DataCursor(index=3))
    np.testing.assert_array_equal(batches[3]["tokens"], next(l2)["tokens"])
    want = next(ShardedLoader(CFG, global_batch=8, seq=16))["tokens"]
    parts = [next(ShardedLoader(CFG, global_batch=8, seq=16, host_id=h,
                                num_hosts=4))["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), want)
    with pytest.raises(ValueError, match="num_hosts"):
        ShardedLoader(CFG, global_batch=6, seq=16, num_hosts=4)


def test_launcher_prints_reference_lines_and_resumes(tmp_path, capsys,
                                                     monkeypatch):
    ck = str(tmp_path / "ck")
    straight = launch_train.main(SMOKE + ["--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    steps = [LINE.match(x) for x in out[:-1]]
    assert all(steps), out
    assert [int(m.group(1)) for m in steps] == [0, 1, 2, 3]
    assert re.match(r"^done: \d+\.\d+$", out[-1]), out[-1]
    # the same run with a checkpoint every 2 steps dies fetching step 3's
    # batch; a second call resumes from step 2
    next_batch = ShardedLoader.__next__

    def dying(loader):
        if loader.cursor.index == 3:
            raise Died
        return next_batch(loader)

    monkeypatch.setattr(ShardedLoader, "__next__", dying)
    with pytest.raises(Died):
        launch_train.main(SMOKE + ["--steps", "4", "--ckpt-dir", ck,
                                   "--ckpt-every", "2"])
    monkeypatch.undo()
    capsys.readouterr()
    resumed = launch_train.main(SMOKE + ["--steps", "4", "--ckpt-dir", ck])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed at step 2"
    assert [int(LINE.match(x).group(1)) for x in out[1:-1]] == [2, 3]
    # the resumed steps are the straight run's, bit for bit on the CPU
    assert [r[1:3] for r in resumed["log"]] == \
        [r[1:3] for r in straight["log"][2:]]
    from repro_torch.ckpt.checkpoint import CheckpointManager, flatten_state
    for (pa, a), (pb, b) in zip(
            flatten_state((resumed["params"], resumed["ostate"])),
            flatten_state((straight["params"], straight["ostate"])),
            strict=True):
        assert pa == pb and torch.equal(a, b), pa
    assert int(resumed["ostate"].count) == 4
    assert CheckpointManager(ck).all_steps() == [2, 4]


def test_launcher_raises_without_card_and_on_model_axis(monkeypatch):
    # --model-axis 2 asks for a mesh of a multiple of 2 ranks; without a
    # process group there is one
    with pytest.raises(ValueError, match="model=2 does not divide the 1 "
                                         "ranks"):
        launch_train.main(SMOKE + ["--steps", "1", "--model-axis", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(SMOKE[:-2] + ["--steps", "1"])
