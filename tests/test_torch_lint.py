"""The port's linter (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``): the rule fixtures of
tests/test_analysis.py that mean the same in both frameworks (REPRO003,
REPRO006, REPRO007 and ``# noqa``) give the same findings, line for
line, through both; the torch rules (REPRO001, REPRO002, REPRO004) on
fixtures of their own; the hot scopes it reads off the port's tree; the
port's tree and chip_smoke.py lint clean; and the linter runs with torch
and numpy unimportable."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parent.parent

# tests/test_analysis.py's fixtures for the rules both linters share
SHARED = {
    "repro003_silent": """
        def f(x):
            try:
                return g(x)
            except ValueError:
                return None
    """,
    "repro003_justified": """
        def f(x):
            try:
                return g(x)
            except ValueError:
                return None  # absent cache: recompute downstream
    """,
    "repro003_warned": """
        import warnings

        def f(x):
            try:
                return g(x)
            except ValueError:
                warnings.warn("fallback")
                return None
    """,
    "repro006_zip": """
        import jax

        def pair(a, b):
            return list(zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    """,
    "repro006_strict": """
        import jax

        def pair(a, b):
            return list(zip(jax.tree.leaves(a), jax.tree.leaves(b),
                            strict=True))
    """,
    "repro007_clobber": """
        import os

        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    """,
    "repro007_append": """
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8")
    """,
    "repro007_getenv": """
        import os

        os.environ["XLA_FLAGS"] = (os.getenv("XLA_FLAGS", "") + " --foo")
    """,
    "repro007_other": """
        import os

        os.environ["JAX_PLATFORMS"] = "cpu"
    """,
    "repro007_in_fn": """
        import os

        def force(n):
            os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    """,
    "repro007_suppressed": """
        import os

        os.environ["XLA_FLAGS"] = "--foo"  # noqa: REPRO007
    """,
    "noqa": """
        import jax

        def eval_ppl(params, batches):
            fn = jax.jit(lambda p, b: p)
            tot = 0.0
            for b in batches:
                nll = fn(params, b)
                tot += float(nll)  # noqa: REPRO001
            return tot
    """,
}
WANT = {"repro003_silent": ["REPRO003"], "repro006_zip": ["REPRO006"],
        "repro007_clobber": ["REPRO007"], "repro007_in_fn": ["REPRO007"]}


def _found(linter, src: str, path: str = "mod.py") -> list:
    return [(f.rule, f.line, f.col)
            for f in linter.lint_source(textwrap.dedent(src), path)]


def _rules(src: str, path: str = "mod.py") -> list:
    return [r for r, _, _ in _found(lint, src, path)]


@pytest.mark.parametrize("name", list(SHARED))
def test_shared_rules_match_the_reference_linter(name):
    got, want = _found(lint, SHARED[name]), _found(jlint, SHARED[name])
    assert got == want
    assert [r for r, _, _ in got] == WANT.get(name, [])


@pytest.mark.parametrize("flag", ["TORCH_CUDA_ARCH_LIST", "NVCC_APPEND_FLAGS",
                                  "CUDA_VISIBLE_DEVICES"])
def test_repro007_covers_the_cuda_flags(flag):
    assert _rules(f'import os\nos.environ["{flag}"] = "9.0a"\n') == \
        ["REPRO007"]
    assert _rules(f'import os\nos.environ["{flag}"] = '
                  f'os.environ.get("{flag}", "") + " -g"\n') == []


def test_repro003_check_and_fail_count_as_raising():
    for call in ("check(False, 'refused')", "fail('refused')"):
        src = f"""
            def f(x):
                try:
                    g(x)
                except ValueError:
                    {call}
        """
        assert _rules(src) == []


def test_repro001_host_sync_in_a_captured_body():
    src = """
        import torch

        class EngineFns:
            def step(self, params, toks, caches, pos):
                def body(p, x, c, t):
                    logits = self.decode(p, x, c, t)
                    n = int(torch.argmax(logits))
                    return logits.argmax(-1).cpu()
                return self._call("decode", body, params, toks, caches, pos)
    """
    found = _found(lint, src, "src/repro_torch/serve/engine.py")
    assert [r for r, _, _ in found] == ["REPRO001", "REPRO001"]
    # the same source anywhere else is not hot
    assert _rules(src, "src/repro_torch/serve/fleet.py") == []


def test_repro001_decode_step_graph_block_and_search_loop():
    step = """
        import torch

        def decode_step(cfg, params, token, caches, t):
            x = torch.zeros(3)
            if x.sum().item() > 0:
                pass
            return x

        def prefill(cfg, params, batch):
            return float(torch.ones(1))
    """
    assert _found(lint, step, "src/repro_torch/models/model.py") == [
        ("REPRO001", 6, 7)]
    graph = """
        import torch

        def capture(g, fn, x: torch.Tensor):
            y = fn(x)
            with torch.cuda.graph(g):
                out = fn(x)
                k = x.tolist()
            return y.item(), out
    """
    assert _found(lint, graph) == [("REPRO001", 8, 12)]
    search = """
        import torch

        def run_search(cfg, pcfg, params, batches, stats):
            state = torch.zeros(2)
            n = int(pcfg.steps)
            while n:
                state = state + 1
                if float(state.sum()) > 3:
                    break
                n -= 1
            return state.tolist()
    """
    assert _found(lint, search, "src/repro_torch/core/calibrate.py") == [
        ("REPRO001", 9, 11)]


def test_repro002_clock_pair_around_cuda_work():
    bare = """
        import time
        import torch

        def bench(a, b):
            t0 = time.perf_counter()
            c = torch.matmul(a, b)
            return time.perf_counter() - t0, c
    """
    assert _rules(bare) == ["REPRO002"]
    for fence in ("torch.cuda.synchronize()", "c.item()", "ev.synchronize()",
                  "float(c.sum())"):
        fenced = bare.replace("            return",
                              f"            {fence}\n            return")
        assert _rules(fenced) == [], fence
    step = """
        import time
        from repro_torch.launch.steps import make_train_step
        from repro_torch.kernels.nm_spmm import nm_matmul

        def loop(cfg, ocfg, params, ostate, batches, x, w):
            step = make_train_step(cfg, ocfg)
            t0 = time.time()
            params, ostate, m = step(params, ostate, batches[0])
            dt = time.time() - t0
            t1 = time.time()
            y = nm_matmul(x, w)
            dt1 = time.time() - t1
            t2 = time.time()
            params, ostate, m = step(params, ostate, batches[1])
            loss = float(m["loss"])
            return dt, dt1, time.time() - t2
    """
    assert _found(lint, step) == [("REPRO002", 10, 9), ("REPRO002", 13, 10)]
    host = """
        import time

        def host_only(n):
            t0 = time.perf_counter()
            s = sum(range(n))
            return time.perf_counter() - t0
    """
    assert _rules(host) == []


def test_repro004_numpy_in_a_kernel_launch_path_only():
    src = """
        import numpy as np
        import torch

        def nm_matmul(x, w):
            n = np.asarray(x.shape).prod()
            nm_matmul.launches += 1
            return torch.empty(n)

        def plan_splits(b, k):
            return int(np.ceil(b / k))
    """
    assert _found(lint, src, "src/repro_torch/kernels/nm_spmm.py") == [
        ("REPRO004", 6, 8)]
    assert _rules(src, "src/repro_torch/sparse/apply.py") == []


def test_hot_scopes_of_the_port():
    """The scopes the port's own hot paths are linted as."""
    def scopes(rel):
        return lint.hot_scopes((ROOT / rel).read_text(), rel)
    eng = scopes("src/repro_torch/serve/engine.py")
    src = (ROOT / "src/repro_torch/serve/engine.py").read_text().splitlines()
    assert len(eng["graph"]) == 1 and len(eng["captured"]) == 3
    assert all(src[ln - 1].strip().startswith("def body(")
               for ln in eng["captured"])
    assert scopes("src/repro_torch/models/model.py")["defs"] == [
        "decode_step", "verify_step"]
    assert scopes("src/repro_torch/core/calibrate.py")["loops"] == [
        "run_search"]


def test_port_tree_and_chip_smoke_lint_clean():
    findings = lint.lint_paths([ROOT / "src" / "repro_torch",
                                ROOT / "chip_smoke.py"])
    assert findings == [], "\n".join(str(f) for f in findings)
    noqa = [(p.name, i + 1, line.strip())
            for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                      ROOT / "chip_smoke.py"]
            for i, line in enumerate(p.read_text().splitlines())
            if "# noqa: REPRO" in line]
    # a suppression names its rule and says why
    for name, ln, text in noqa:
        assert text.split("# noqa: REPRO", 1)[1][4:].strip(), (name, ln)


def test_cli_and_rule_list(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "REPRO005" not in out and out.count("REPRO0") == 6
    assert main(["lint", str(ROOT / "src" / "repro_torch" / "tree.py")]) == 0


def test_lint_is_dependency_free():
    code = textwrap.dedent("""
        import sys
        sys.modules["torch"] = None
        sys.modules["numpy"] = None
        from repro_torch.analysis import lint
        assert lint.lint_source("def f():\\n    return 1\\n") == []
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT),
                       env={**os.environ, "PYTHONPATH": "src"})
    assert r.returncode == 0 and "ok" in r.stdout, (r.stdout, r.stderr)
