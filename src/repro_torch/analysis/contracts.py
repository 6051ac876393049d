"""Trace contracts: golden manifests per surface, checked statically.

Port of ``repro.analysis.contracts``.  A manifest pins what one call of a
surface (``analysis.audit``, on the ``meta`` device) is ALLOWED to look
like:

* ``psums_by_site`` / ``collectives`` - collectives per call site, as the
  flight recorder's trace-time ``dist.psum`` counters count them ({} on
  one card unless ``kv_shards`` >= 2 stands in for a mesh);
* ``host_callbacks`` - host syncs: must be 0 on every hot path;
* ``large_f32_upcasts`` - silent bf16->f32 promotions of large tensors
  (the f32-accumulation operands are exempt);
* ``arg_bytes`` / ``out_bytes`` / ``dtypes`` - the bytes in and out and
  the dtype set (catches a silent widening of params or caches);
* ``donation_declared`` - argument tensors the call updates in place (the
  port's donation; the reference counts the leaves it declares donated);
* ``kernel_calls`` / ``kernel_pairs`` - the hand-written kernels called,
  once per scanned call site (the reference's ``pallas_call`` eqns), and
  the pairs over one input (one call on the reference's CPU route).

The port's goldens live in ``src/repro_torch/analysis/golden/``
(:data:`GOLDEN_DIR`), named as the reference names its own under
``results/contracts/``; ``check`` re-audits and diffs, and any drift fails
loudly.  Regenerate on purpose with ``python -m repro_torch.analysis
contracts --update``.  Volatile facts (the op histogram, op counts, the
torch version) sit under ``info`` and are not compared.

:data:`REFERENCE_FIELDS` are the fields a port manifest shares with the
reference's golden value for value; the others differ for representational
reasons that the tests list field by field (ROADMAP C, R25).
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Iterable

from repro_torch.analysis import audit
from repro_torch.analysis.surfaces import Surface

__all__ = ["COMPARE_FIELDS", "REFERENCE_FIELDS", "GOLDEN_DIR",
           "build_manifest", "diff_manifests", "check", "save", "load",
           "manifest_path", "policy_violations", "reference_kernel_calls"]

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "golden"

COMPARE_FIELDS = ("psums_by_site", "collectives", "host_callbacks",
                  "large_f32_upcasts", "dtypes", "arg_bytes", "out_bytes",
                  "donation_declared", "policy", "kernel_calls",
                  "kernel_pairs")

# fields equal to the reference's golden on every surface
REFERENCE_FIELDS = ("psums_by_site", "collectives", "host_callbacks",
                    "large_f32_upcasts", "policy")

# standing policy every hot surface must satisfy regardless of golden; the
# upcast ban applies to "serve" surfaces only (see surfaces.Surface)
POLICY = {"host_callbacks": 0, "large_f32_upcasts": 0,
          "forbidden_dtypes": ("float64",)}


def _surface_entry(rep: audit.AuditReport, *, policy: str = "serve") -> dict:
    return {
        "policy": policy,
        "psums_by_site": dict(sorted(rep.psums_by_site.items())),
        "collectives": dict(sorted(rep.collectives.items())),
        "host_callbacks": len(rep.host_callbacks),
        "large_f32_upcasts": rep.large_f32_upcasts,
        "dtypes": rep.dtypes,
        "arg_bytes": rep.arg_bytes,
        "out_bytes": rep.out_bytes,
        "donation_declared": rep.donated_in_place,
        "kernel_calls": dict(sorted(rep.kernel_calls.items())),
        "kernel_pairs": rep.kernel_pairs,
        "info": {"n_ops": rep.n_ops,
                 "primitives": dict(sorted(rep.primitives.items())),
                 "upcasts": rep.upcasts,
                 "host_callback_sites": rep.host_callbacks,
                 "kernel_launches": rep.kernel_launches,
                 "device": rep.device},
    }


def build_manifest(name: str, surfaces: Iterable[Surface], *,
                   mesh_shape: tuple | None = None,
                   device: str | None = "meta") -> dict:
    """Audit every surface (on ``meta`` by default) into one manifest."""
    import torch
    from repro_torch.analysis.surfaces import no_mesh
    no_mesh(mesh_shape)
    out: dict[str, Any] = {"name": name, "mesh": None, "surfaces": {}}
    for s in surfaces:
        rep = audit.audit_fn(s.fn, *s.args, surface=s.name, device=device)
        out["surfaces"][s.name] = _surface_entry(rep, policy=s.policy)
    out["info"] = {"torch": torch.__version__}
    return out


def reference_kernel_calls(entry: dict) -> int:
    """A port surface entry's kernel calls as the reference's CPU route
    makes them (one call per pair), its golden's ``pallas_call`` count."""
    return sum(entry["kernel_calls"].values()) - entry["kernel_pairs"]


def policy_violations(manifest: dict) -> list[dict]:
    """Standing-policy violations (independent of any golden)."""
    out = []
    for name, e in manifest.get("surfaces", {}).items():
        if e["host_callbacks"] > POLICY["host_callbacks"]:
            out.append({"surface": name, "field": "host_callbacks",
                        "got": e["host_callbacks"], "allowed": 0})
        if (e.get("policy", "serve") == "serve"
                and e["large_f32_upcasts"] > POLICY["large_f32_upcasts"]):
            out.append({"surface": name, "field": "large_f32_upcasts",
                        "got": e["large_f32_upcasts"], "allowed": 0})
        bad = sorted(set(e["dtypes"]) & set(POLICY["forbidden_dtypes"]))
        if bad:
            out.append({"surface": name, "field": "dtypes", "got": bad,
                        "allowed": f"none of {POLICY['forbidden_dtypes']}"})
    return out


def diff_manifests(golden: dict, current: dict,
                   fields: tuple = COMPARE_FIELDS) -> list[dict]:
    """Structured drift between a golden and a freshly built manifest."""
    diffs = []
    gs = golden.get("surfaces", {})
    cs = current.get("surfaces", {})
    for name in sorted(set(gs) | set(cs)):
        if name not in cs:
            diffs.append({"surface": name, "field": "<surface>",
                          "golden": "present", "current": "missing"})
            continue
        if name not in gs:
            diffs.append({"surface": name, "field": "<surface>",
                          "golden": "missing", "current": "present"})
            continue
        for f in fields:
            g, c = gs[name].get(f), cs[name].get(f)
            if g != c:
                diffs.append({"surface": name, "field": f,
                              "golden": g, "current": c})
    return diffs


def manifest_path(contracts_dir, name: str,
                  mesh_shape: tuple | None) -> pathlib.Path:
    tag = "x".join(str(d) for d in mesh_shape) if mesh_shape else "1dev"
    return pathlib.Path(contracts_dir) / f"{name}_{tag}.json"


def save(path, manifest: dict) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def load(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def check(golden_path, current: dict) -> tuple[bool, list[dict]]:
    """(ok, diffs) of ``current`` against the golden at ``golden_path``; a
    missing golden is itself a failure (contracts are committed)."""
    p = pathlib.Path(golden_path)
    if not p.exists():
        return False, [{"surface": "*", "field": "<golden>",
                        "golden": f"missing file {p}", "current": "built"}]
    diffs = diff_manifests(load(p), current)
    diffs.extend({"surface": v["surface"], "field": f"policy:{v['field']}",
                  "golden": v["allowed"], "current": v["got"]}
                 for v in policy_violations(current))
    return not diffs, diffs
