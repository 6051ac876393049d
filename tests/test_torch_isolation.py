"""repro_torch stands alone: it imports neither jax nor the JAX package,
runs its CPU path with both unimportable (llama from the committed bank,
2:4 mixtral smoke, whisper's and pixtral's launcher loop), and its entry
points refuse to run silently on the CPU
when no card is present."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path} imports {bad}"


def test_cpu_serve_with_jax_and_repro_unimportable():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import pkgutil, importlib, repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.models import model as M
        from repro_torch.serve.engine import ServeEngine
        cfg = get_smoke_config("llama3.2-1b")
        params = M.init_params(cfg, 0, device="cpu")
        eng = ServeEngine.from_artifact("results/bank/llama3.2-1b", params,
                                        slots=2, capacity=32, device="cpu")
        rids = [eng.submit([1, 2, 3, 4], 3), eng.submit([5, 6], 2)]
        out = eng.run()
        assert [len(out[r]) for r in rids] == [3, 2], out
        # 2:4-compressed mixtral smoke: MoE expert banks, sliding window,
        # untied lm_head
        from repro_torch import tree
        from repro_torch.core.calibrate import baseline_masks
        from repro_torch.sparse.apply import sparsify_params
        cfg = get_smoke_config("mixtral-8x22b")
        params = M.init_params(cfg, 0, device="cpu")
        masks = baseline_masks("magnitude", params,
                               tree.tree_map(lambda _: None, params), 0.5,
                               mode="nm")
        params = sparsify_params(params, masks, axes=M.param_axes(cfg),
                                 idx_bits=2)
        eng = ServeEngine(cfg, params, slots=2, capacity=24, device="cpu")
        rids = [eng.submit(list(range(1, 21)), 4), eng.submit([7, 8], 3)]
        out = eng.run()
        assert [len(out[r]) for r in rids] == [4, 3], out
        # the encoder-decoder and the vision prefix through the launcher
        from repro_torch.data.synthetic import batches_for
        from repro_torch.launch.serve import generate
        for arch in ("whisper-small", "pixtral-12b"):
            cfg = get_smoke_config(arch)
            params = M.init_params(cfg, 0, device="cpu")
            batch = batches_for(cfg, n=1, batch=2, seq=8, split="valid")[0]
            assert tuple(generate(cfg, params, batch, 3)[0].shape) == (2, 3)
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "ok" in r.stdout, (r.stdout, r.stderr)


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse.bank import MaskBank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3.2-1b")
    params = M.init_params(cfg, 0, device="cpu")
    for call in (lambda: M.init_params(cfg),
                 lambda: ServeEngine(cfg, params),
                 lambda: ServeEngine.from_artifact(
                     ROOT / "results/bank/llama3.2-1b", params),
                 lambda: MaskBank.load(ROOT / "results/bank/llama3.2-1b"),
                 lambda: launch_serve.main(["--arch", "llama3.2-1b",
                                            "--smoke", "--gen", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_launcher_runs_bank_backed_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                       "--prompt-len", "16", "--gen", "3", "--device", "cpu",
                       "--sparse-artifact",
                       str(ROOT / "results/bank/llama3.2-1b")])
    out = capsys.readouterr().out
    assert "7 kernels 2:4-compressed" in out and "ratio 0.562" in out
    assert "sample continuation" in out


def test_calibrate_launcher_raises_when_no_card(monkeypatch, tmp_path):
    from repro_torch.launch import calibrate as launch_calibrate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_calibrate.main(["--arch", "llama3.2-1b", "--smoke", "--out",
                               str(tmp_path / "bank"), "--steps", "1"])
    assert not (tmp_path / "bank").exists()


def test_cpu_calibration_with_jax_and_repro_unimportable(tmp_path):
    """The launcher calibrates on the CPU without jax, and the engine serves
    2:4 weights from the bank it wrote."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.launch import calibrate
        from repro_torch.models import model as M
        from repro_torch.serve.engine import ServeEngine
        calibrate.main(["--arch", "llama3.2-1b", "--smoke", "--out",
                        {str(tmp_path / "bank")!r}, "--steps", "2",
                        "--calib-n", "2", "--batch", "2", "--seq", "32",
                        "--device", "cpu"])
        cfg = get_smoke_config("llama3.2-1b")
        params = M.init_params(cfg, 0, device="cpu")
        eng = ServeEngine.from_artifact({str(tmp_path / "bank")!r}, params,
                                        slots=2, capacity=32, device="cpu")
        rid = eng.submit([1, 2, 3, 4], 3)
        assert len(eng.run()[rid]) == 3
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "ok" in r.stdout, (r.stdout, r.stderr)
    assert "calibrated llama3.2-1b (smoke): 2 search steps" in r.stdout


def test_kv_shards_serving_with_jax_and_repro_unimportable():
    """The decode attention paths (kernels/flash_decode.py and
    kernels/shard.py through ServeEngine's kv_shards) serve on the CPU
    without jax, as the replicated path does, token for token here."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.kernels import flash_decode, shard
        from repro_torch.models import model as M
        from repro_torch.serve.engine import ServeEngine
        cfg = get_smoke_config("llama3.2-1b")
        params = M.init_params(cfg, 0, device="cpu")
        streams = []
        for kv_shards in (None, 1, 4):
            eng = ServeEngine.from_artifact(
                "results/bank/llama3.2-1b", params, slots=2, capacity=32,
                device="cpu", kv_shards=kv_shards)
            rids = [eng.submit([1, 2, 3, 4], 3), eng.submit([5, 6], 2)]
            out = eng.run()
            streams.append([out[r] for r in rids])
        assert [len(s) for s in streams[0]] == [3, 2], streams
        print(streams)
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "ok" in r.stdout, (r.stdout, r.stderr)


def test_cpu_training_with_jax_and_repro_unimportable(tmp_path):
    """The train launcher trains 2 smoke steps on the CPU without jax,
    checkpoints, and a second call resumes from its checkpoint."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)    # beside the test runner's workers
        from repro_torch.launch import train
        argv = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                "--seq", "32", "--log-every", "1", "--device", "cpu",
                "--ckpt-dir", {str(tmp_path / "ck")!r}]
        train.main(argv + ["--steps", "2"])
        train.main(argv + ["--steps", "3"])
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "ok" in r.stdout, (r.stdout, r.stderr)
    lines = r.stdout.splitlines()
    assert all(x.startswith("step ") for x in lines[:2])
    assert "resumed at step 2" in lines
    assert sum(x.startswith("done: ") for x in lines) == 2
