"""repro_torch stands alone: it imports neither jax nor the JAX package,
runs its CPU path with both unimportable, and its entry points refuse to
run silently on the CPU when no card is present."""
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
