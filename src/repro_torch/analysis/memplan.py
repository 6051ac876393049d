"""Static memory planner: storage liveness, kernel launch footprints, fit
tables.  Port of ``repro.analysis.memplan`` without a mesh.

Answers "does this surface / this SearchState / this shape cell fit one
card" without allocating, from three cooperating estimates:

* :func:`plan_fn` - a liveness sweep over the op stream of one call
  (``analysis.audit.OpRecorder``, on the ``meta`` device by default): a
  storage is allocated when an op creates it and freed when its last
  reference dies; an in-place update, or a view, reuses its operand's
  storage.  Every size is rounded to :data:`ALLOC_ROUND`, the CUDA caching
  allocator's block granularity, so a plan reads in the bytes
  ``torch.cuda.memory_allocated`` counts.  ``temp_bytes`` is the peak of
  the intermediates (the reference's static temp), ``peak_bytes`` the peak
  of everything the call allocates (its outputs too), what
  ``torch.cuda.max_memory_allocated`` rises by over one call
  (:func:`crosscheck`), and ``total_bytes`` the reference's
  ``arg + out + temp - alias``, the alias credit being the outputs that
  are arguments updated in place (the engine's caches);
* each hand-written kernel call's launch (:class:`KernelLaunch`, the
  counterpart of the reference's ``PallasCall`` VMEM footprint): the
  instantiation its wrapper picks, the grid, the dynamic shared memory the
  launch passes plus the static shared memory of the instantiation (as
  ``csrc/*.cu`` declares it; ``chip_smoke.py`` holds both against
  ``cudaFuncGetAttributes`` through the sources' ``*_smem`` entry points),
  and the split-K workspace a ``nm_matmul`` launch allocates for itself,
  which the sweep counts at that op;
* :func:`search_plan` - the SearchState of ``core.mirror.init_search`` on
  ``meta`` (nothing allocated), byte for byte the reference's layout
  (:func:`search_state_bytes`), extended into a fit table for one card:
  at which layer-group size streaming the Gamma/V shadows becomes
  mandatory.  The budget is the card's: 80 GB nominal when planning on a
  host without one (:data:`CARD_BYTES`), ``total_memory`` on the card.

Meshes (``device_counts`` other than one card) wait for tensor
parallelism (ROADMAP A item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import torch

from repro_torch.analysis import audit

__all__ = ["MemPlan", "KernelLaunch", "kernel_launch", "plan_fn",
           "plan_surface", "plan_recorded", "crosscheck", "search_state_bytes", "search_plan", "fit_table",
           "format_fit_table", "round_alloc", "ALLOC_ROUND", "CARD_BYTES",
           "H100_SMS", "card_budget", "serving_params_meta",
           "param_bytes"]

ALLOC_ROUND = 512           # the CUDA caching allocator's block granularity
CARD_BYTES = 80e9           # an H100 80GB, nominal
H100_SMS = 132              # streaming multiprocessors of an H100 SXM


def round_alloc(n: int, granularity: int = ALLOC_ROUND) -> int:
    """Bytes the caching allocator hands out for an ``n``-byte request."""
    if n <= 0 or granularity <= 1:
        return max(n, 0)
    return -(-n // granularity) * granularity


def card_budget(device=None) -> float:
    """The planning budget: the card's ``total_memory`` on a CUDA device,
    else :data:`CARD_BYTES`."""
    if device is not None and torch.device(device).type == "cuda":
        return float(torch.cuda.get_device_properties(
            torch.device(device)).total_memory)
    return CARD_BYTES


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelLaunch:
    """One hand-written kernel call's launch as its wrapper configures it.
    ``query``: (library, entry point, selectors) of the source's ``*_smem``
    entry point that reports the instantiation's shared memory."""
    name: str
    instantiation: str
    grid: tuple
    threads: int
    static_smem: int
    dynamic_smem: int
    workspace_bytes: int = 0
    query: tuple = ()

    @property
    def smem_bytes(self) -> int:
        return self.static_smem + self.dynamic_smem

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid"] = list(self.grid)
        d["query"] = list(self.query)
        d["smem_bytes"] = self.smem_bytes
        return d


_MMA_TILES = ((8, 1, 1), (16, 2, 1), (32, 4, 1), (40, 5, 1))  # M<=, TM, WM
# the static shared memory of nm_spmm.cu's split-K arrival flag (one
# bool): the compiler gives it a 128-byte slot (cudaFuncGetAttributes on
# an H100, CUDA 12)
_FLAG_SLOT = 128
_BN = 64
_FD_CHUNK, _FD_WARPS, _FD_SMEM_LIMIT = 16, 4, 227 * 1024


def _nm_launch(name: str, call, sm_count: int) -> KernelLaunch:
    from repro_torch.kernels import nm_spmm
    (xs, vs, ids), (xd, _, _) = call.shapes[:3], call.dtypes[:3]
    experts = name == "nm_matmul_expert"
    E = xs[0] if experts else 1
    M, K = xs[-2:]
    N = vs[-1]
    packed = ids[-2] * 8 == K
    bf16 = xd == "bfloat16"
    if bf16:
        TM, WM = next(((tm, wm) for lim, tm, wm in _MMA_TILES if M <= lim),
                      (4, 2))
        BM = WM * TM * 8
        # Tile<TM, WM>: 3 stages of vals (64 x 64 bf16), packed idx
        # (16 x 64) and x (BM x 128 bf16), or the f32 epilogue tile
        stage = 64 * _BN * 2 + 16 * _BN + BM * 128 * 2
        dyn = max(3 * stage, BM * (_BN + 4) * 4)
        static, threads = _FLAG_SLOT, 32 * 4 * WM
        inst = f"nm_mma_kernel<{TM},{WM}>"
    else:
        BM = next((b for b in (1, 2, 4, 8) if M <= b), 16)
        dyn, threads = 0, 256
        static = 8 * 16 * _BN * 4 + _FLAG_SLOT   # the partial sums
        inst = f"nm_simt_kernel<{str(packed).lower()},{BM}>"
    ksplit, _ = nm_spmm.split_k(M, K, N, sm_count, experts=E, bf16=bf16)
    ws = ksplit * E * M * N * 4 if ksplit > 1 else 0
    grid = (-(-N // _BN), ksplit, E * -(-M // BM))
    return KernelLaunch(name, inst, grid, threads, static, dyn, ws,
                        ("nm_spmm", "repro_nm_matmul_smem", M, int(bf16),
                         int(packed)))


def flash_smem(D: int, G: int, bf16: bool) -> int:
    """``Shape<T, D, G>::SMEM`` of ``csrc/flash_decode.cu``."""
    size = 2 if bf16 else 4
    row = D * size // 16 + 1                  # padded row, 16-byte units
    stage = 2 * _FD_CHUNK * row * 16 + _FD_CHUNK * 4
    state = (G * D + 16) * 4
    fixed = state + (0 if bf16 else G * (D + 4) * 4)
    stages = 2 if fixed + _FD_WARPS * 2 * stage <= _FD_SMEM_LIMIT else 1
    return fixed + _FD_WARPS * stages * stage


def _flash_launch(name: str, call, sm_count: int) -> KernelLaunch:
    from repro_torch.kernels.flash_decode import plan_splits
    q, k = call.shapes[0], call.shapes[1]
    B, K, G, D = q
    C = k[1]
    S = int(call.kwargs.get("shards", 1))
    bf16 = call.dtypes[0] == "bfloat16"
    partial = name == "flash_decode_partial"
    P = plan_splits(B, K, C, S, sm_count)
    t = "bf16" if bf16 else "f32"
    return KernelLaunch(
        name, f"flash_decode_kernel<{t},{D},{G},{str(partial).lower()}>",
        (S * P, K, B), 128, 0, flash_smem(D, G, bf16), 0,
        (f"flash_decode_{t}", "repro_flash_decode_smem", D, G, int(bf16),
         int(partial)))


def _elementwise(name: str, cells: int, inst: str, query: tuple
                 ) -> KernelLaunch:
    return KernelLaunch(name, inst, (-(-cells // 256),), 256, 0, 0, 0, query)


_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
_METRICS = {"wanda": 0, "magnitude": 1, "ria": 2, "stochria": 2}


def kernel_launch(call: "audit.KernelCall",
                  sm_count: int = H100_SMS) -> KernelLaunch:
    """The launch the wrapper of ``call`` configures on a card with
    ``sm_count`` SMs."""
    name = call.name
    if name in ("nm_matmul", "nm_matmul_expert"):
        return _nm_launch(name, call, sm_count)
    if name in ("flash_decode", "flash_decode_partial"):
        return _flash_launch(name, call, sm_count)
    if name == "combine_partials":
        S, B, K, G, Dv = call.shapes[0]
        dt = (call.positional or [call.kwargs.get("out_dtype")])[0]
        code = int(dt == torch.bfloat16)
        t = "bf16" if code else "f32"
        return KernelLaunch(name, f"combine_kernel<{t}>", (B * K,), 128, 0, 0,
                            0, (f"flash_decode_{t}",
                                "repro_flash_decode_combine_smem", code))
    R, N = call.shapes[0]
    code = _CODES[call.dtypes[0]]
    if name == "saliency_fused_step":
        metric = call.kwargs.get("metric", "wanda")
        div = int("s_div" in call.tensor_kwargs)
        return _elementwise(name, R * N,
                            f"saliency_fuse_kernel<{call.dtypes[0]},"
                            f"{metric}>", ("saliency_fuse",
                                           "repro_saliency_fused_step_smem",
                                           code, _METRICS[metric], div))
    if name == "prox24":
        return _elementwise(name, R // 4 * N, f"prox24_kernel<"
                            f"{call.dtypes[0]}>", ("prox24",
                                                   "repro_prox24_smem", code))
    if name == "nm_mask24":
        return _elementwise(name, R // 4 * N, f"nm_mask24_kernel<"
                            f"{call.dtypes[0]}>", ("nm_mask24",
                                                   "repro_nm_mask24_smem",
                                                   code))
    raise ValueError(f"no launch model for kernel {name!r}")


# ---------------------------------------------------------------------------
# Liveness planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MemPlan:
    """Static memory plan of one call of a surface (bytes rounded to the
    allocator's blocks)."""
    surface: str
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0          # peak of the intermediates
    alias_bytes: int = 0         # outputs that are arguments (in place)
    peak_bytes: int = 0          # peak of everything the call allocates
    donation_declared: int = 0   # argument tensors updated in place
    kernels: list = dataclasses.field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return self.arg_bytes + self.out_bytes + self.temp_bytes \
            - self.alias_bytes

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kernels"] = [k.to_dict() if isinstance(k, KernelLaunch) else k
                        for k in self.kernels]
        d["total_bytes"] = self.total_bytes
        return d


def _storage_bytes(tensors: list[torch.Tensor], granularity: int) -> int:
    """Rounded bytes of the distinct storages under ``tensors``."""
    seen: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = round_alloc(st.nbytes(), granularity)
    return sum(seen.values())


def _peak(events: list[tuple[int, int]]) -> int:
    """Peak of a running sum of (op index, +-bytes) events, frees at an
    index applied before allocations at it."""
    live = peak = 0
    for _, b in sorted(events, key=lambda e: (e[0], e[1])):
        live += b
        peak = max(peak, live)
    return peak


def plan_recorded(rec: "audit.OpRecorder", args, out, *,
                  surface: str = "?", sm_count: int = H100_SMS,
                  granularity: int = ALLOC_ROUND) -> MemPlan:
    """The plan of a call recorded with ``track_memory``."""
    plan = MemPlan(surface=surface)
    arg_ts, out_ts = audit.tensors(args), audit.tensors(out)
    plan.arg_bytes = _storage_bytes(arg_ts, granularity)
    out_keys = {t.untyped_storage()._cdata for t in out_ts}
    plan.out_bytes = _storage_bytes(out_ts, granularity)
    plan.alias_bytes = _storage_bytes(
        [t for t in out_ts if t.untyped_storage()._cdata in rec.arg_keys],
        granularity)
    plan.donation_declared = rec.rep.donated_in_place
    end = rec.n + 1
    temp, every = [], []
    for key, nbytes, first, last, _ in rec.spans:
        b = round_alloc(nbytes, granularity)
        last = end if last is None else last
        ev = [(first, b), (last, -b)]
        every += ev
        if key not in out_keys or last != end:
            temp += ev
    for kc in rec.kernels:
        launch = kernel_launch(kc, sm_count)
        plan.kernels.append(launch)
        if launch.workspace_bytes:
            b = round_alloc(launch.workspace_bytes, granularity)
            ev = [(kc.op, b), (kc.op + 1, -b)]
            temp += ev
            every += ev
    plan.temp_bytes = _peak(temp)
    plan.peak_bytes = _peak(every)
    return plan


def plan_fn(fn: Callable, *args, surface: str = "?",
            device: str | None = "meta", sm_count: int = H100_SMS,
            granularity: int = ALLOC_ROUND) -> MemPlan:
    """Record one call of ``fn(*args)`` (on ``meta`` by default: the
    arguments are moved there; None runs it where they lie) and plan it."""
    if device is not None:
        fn = audit.fn_to_device(fn, device)
        args = audit.to_device(args, device)
    rec, out = audit.record(fn, *args, surface=surface, track_memory=True)
    return plan_recorded(rec, args, out, surface=surface, sm_count=sm_count,
                         granularity=granularity)


def plan_surface(surface, **kwargs) -> MemPlan:
    """:func:`plan_fn` of an ``analysis.surfaces.Surface``."""
    return plan_fn(surface.fn, *surface.args, surface=surface.name,
                   **kwargs)


def crosscheck(fn: Callable, *args, surface: str = "?") -> dict:
    """The plan of one call against the card: ``fn(*args)`` (CUDA tensors)
    is planned on ``meta`` with the card's SM count, run once to make what
    a first call makes (library workspaces, ``nm_matmul``'s split-K
    counters), then measured on a second call: ``max_memory_allocated``'s
    rise over ``memory_allocated`` before it, against ``peak_bytes``."""
    dev = audit.tensors(args)[0].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_fn(fn, *args, surface=surface, sm_count=sms)
    fn(*args)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    measured = torch.cuda.max_memory_allocated(dev) - before
    del out
    return {"surface": surface, "planned_peak": plan.peak_bytes,
            "measured_peak": measured,
            "rel_err": (plan.peak_bytes - measured) / max(measured, 1),
            "plan": plan.to_dict()}


# ---------------------------------------------------------------------------
# Parameters on meta
# ---------------------------------------------------------------------------

def param_bytes(t, granularity: int = 1) -> int:
    """Bytes of a tree's tensors, each rounded to ``granularity``."""
    return sum(round_alloc(x.numel() * x.element_size(), granularity)
               for x in audit.tensors(t))


def params_meta(cfg, dtype: torch.dtype | None = None):
    """``cfg``'s parameter tree as meta tensors (``model.param_specs``),
    each in its own dtype or ``dtype``."""
    from repro_torch import tree
    from repro_torch.models import model as M
    return tree.tree_map(lambda s: torch.empty(
        s.shape, dtype=dtype or s.dtype, device="meta"), M.param_specs(cfg))


def serving_params_meta(cfg, *, sparse: bool = True):
    """The serving tree of ``cfg`` on meta, as ``ServeEngine`` holds it:
    with ``sparse``, every prunable kernel that a 2:4 mask can compress
    (per layer 2-D or an MoE expert bank, K % 4 == 0) as a packed2
    ``SparseTensor`` in bf16 (``sparse.apply.sparsify_params``), the rest
    cast by ``model.serving_params``."""
    from repro_torch import tree
    from repro_torch.core.prunable import prunable_map
    from repro_torch.models import model as M
    from repro_torch.sparse import apply as apply_mod
    from repro_torch.sparse.formats import SparseTensor
    params = params_meta(cfg)
    if sparse:
        pr = prunable_map(params)
        flat_a = [a for _, a in tree.flatten_with_path(M.param_axes(cfg))]
        flat_p = [p for _, p in tree.flatten_with_path(pr)]
        out = []
        for (path, w), ax, p in zip(tree.flatten_with_path(params), flat_a,
                                    flat_p, strict=True):
            eff = w.dim() - (1 if apply_mod._stacked(ax) else 0)
            if p and w.shape[-2] % 4 == 0 and (
                    eff == 2 or apply_mod._is_expert_bank(path, eff)):
                *lead, K, N = w.shape
                w = SparseTensor(
                    torch.empty((*lead, K // 2, N), dtype=torch.bfloat16,
                                device="meta"),
                    torch.empty((*lead, -(-(K // 2) // 4), N),
                                dtype=torch.uint8, device="meta"),
                    idx_bits=2)
            out.append(w)
        params = tree.unflatten_like(params, out)
    return M.serving_params(params)


# ---------------------------------------------------------------------------
# SearchState fit planning
# ---------------------------------------------------------------------------

def _state(arch: str, *, smoke: bool = True):
    """(cfg, the SearchState of ``init_search`` on meta)."""
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.core import mirror
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return cfg, mirror.init_search(params_meta(cfg), 17)


# the reference's SearchState leaves the port keeps on the host: the step
# counter (an int32 scalar there) and the threefry key (two uint32 words)
_HOST_LEAF_BYTES = 4 + 8


def search_state_bytes(arch: str, *, smoke: bool = True) -> int:
    """SearchState bytes in the reference's layout, leaf for leaf its
    ``memplan.search_state_bytes``: W, Gamma and V on the device, plus
    the step counter and the key that the reference holds as arrays and
    the port on the host (:data:`_HOST_LEAF_BYTES`)."""
    _, state = _state(arch, smoke=smoke)
    return audit.tree_bytes((state.W, state.Gamma, state.V)) \
        + _HOST_LEAF_BYTES


def _one_card(device_counts) -> None:
    if tuple(device_counts) != (1,):
        raise NotImplementedError(
            f"device_counts={tuple(device_counts)}: fit tables over a mesh "
            "wait for tensor parallelism (ROADMAP A item 7); the port plans "
            "one card")


def search_plan(arch: str, *, smoke: bool = False,
                device_counts: Iterable[int] = (1,),
                budget_bytes: float | None = None) -> dict:
    """Does config ``arch``'s SearchState fit one card, and if not, at what
    layer-group size does streaming the Gamma/V shadows become mandatory?
    The reference's model: W stays resident and the shadows page in groups
    of ``g`` layers, ``resident(g) = W + shadows * g / L``."""
    _one_card(device_counts)
    cfg, state = _state(arch, smoke=smoke)
    w_bytes = audit.tree_bytes(state.W)
    shadow_bytes = audit.tree_bytes((state.Gamma, state.V))
    total = search_state_bytes(arch, smoke=smoke)
    L = cfg.num_layers
    budget = CARD_BYTES if budget_bytes is None else budget_bytes
    if w_bytes + shadow_bytes / L > budget:
        g_max = None
    elif w_bytes + shadow_bytes <= budget:
        g_max = L
    else:
        g_max = max(1, int((budget - w_bytes) * L // max(shadow_bytes, 1)))
    row = {"devices": 1, "state_bytes_per_device": total,
           "fits": bool(total <= budget), "max_group_layers": g_max,
           "streaming_mandatory": g_max is not None and g_max < L}
    return {"arch": arch, "smoke": smoke, "num_layers": L,
            "state_bytes": total, "w_bytes": w_bytes,
            "shadow_bytes": shadow_bytes, "budget_bytes": budget,
            "sqrt_group_layers": max(1, round(math.sqrt(L))),
            "per_mesh": [row]}


def fit_table(archs: Iterable[str] | None = None, *, smoke: bool = False,
              budget_bytes: float | None = None) -> list[dict]:
    """The whole-zoo SearchState fit table for one card (meta tensors)."""
    from repro_torch.configs.base import ARCH_IDS
    return [search_plan(a, smoke=smoke, budget_bytes=budget_bytes)
            for a in (archs or ARCH_IDS)]


def format_fit_table(rows: list[dict]) -> str:
    """Fixed-width rendering of :func:`fit_table`."""
    out = ["arch                    layers   state GB  budget GB  "
           "fit@1card  sqrtL  max group  stream"]
    for r in rows:
        one = r["per_mesh"][0]
        g = one["max_group_layers"]
        stream = "-" if g is None else (
            "mandatory" if one["streaming_mandatory"] else "optional")
        out.append(f"{r['arch']:<22s} {r['num_layers']:>6d} "
                   f"{r['state_bytes'] / 1e9:>9.2f} "
                   f"{r['budget_bytes'] / 1e9:>9.2f}  "
                   f"{'yes' if one['fits'] else 'NO':>9s}  "
                   f"{r['sqrt_group_layers']:>5d}  "
                   f"{'-' if g is None else g:>9}  "
                   f"{stream}")
    return "\n".join(out)
