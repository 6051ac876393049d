"""Model / run configuration dataclasses and the architecture registry.

Field-for-field copy of ``repro.configs.base`` (which imports jax): a bank
artifact's ``pcfg`` and a config's fields mean the same in both packages.
Config modules so far: ``llama3.2-1b``, ``mixtral-8x22b``, ``gemma3-1b``,
``gemma2-2b`` and ``yi-6b``; the paper-table harness's tiny families are
in ``configs/tiny.py``.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|hybrid|ssm|audio|vlm
    d_model: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # layer-kind pattern, cycled over num_layers (see models/blocks.py)
    pattern: tuple[str, ...] = ("attn",)
    pattern_prefix: tuple[str, ...] = ()   # e.g. deepseek first-dense layer
    # attention
    rope_theta: float = 10000.0
    local_rope_theta: float = 0.0   # 0 -> use rope_theta for local layers too
    sliding_window: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    attn_scale: float = 0.0         # 0 -> head_dim**-0.5
    sandwich_norm: bool = False     # gemma2-style post-block norms
    tie_embeddings: bool = True
    scale_embed: bool = False       # gemma: embed * sqrt(d_model)
    # MLA (deepseek)
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    # xLSTM
    lstm_heads: int = 4
    lstm_proj_factor: float = 2.0
    # zamba-style shared attention block
    lora_rank: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    # VLM (pixtral)
    vit_dim: int = 0
    num_image_tokens: int = 0
    # norms / activations
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"
    use_rope: bool = True
    norm_eps: float = 1e-6
    # serving: end-of-sequence token id terminating a decode slot
    # (None -> generation stops on max_tokens only)
    eos_id: int | None = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        n = self.num_layers - len(self.pattern_prefix)
        return self.pattern_prefix + tuple(
            self.pattern[i % len(self.pattern)] for i in range(n))

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE_CONFIG


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """UniPruning search-stage hyperparameters (paper §5: lr 1e-4, λ=1e-3)."""
    local_metric: str = "stochria"   # magnitude | wanda | ria | stochria
    mode: str = "unstructured"       # unstructured | nm
    nm_n: int = 2
    nm_m: int = 4
    rho: float = 1e-5                # alignment weight (paper Table 5)
    lam: float = 1e-3                # Omega = lam * L1 (paper A.3.3)
    kappa: float = 1.0
    lr: float = 1e-4                 # alpha
    # Effective dual step alpha*rho for the V update.  The paper's raw
    # product (1e-9) needs ~1e5 steps at LLM activation scales; v_lr plays
    # the same role with a calibration-friendly default (see DESIGN.md #8).
    v_lr: float = 0.1
    steps: int = 100
    # Per-tensor score normalization anchoring Gamma to cross-layer-
    # comparable saliency; "none" = paper-faithful raw scores.
    score_norm: str = "median"
    nm_prox_weight: float = 1e-2     # strength of R_{2:4} prox on W
    stoch_frac: float = 0.9          # stochRIA row/col sampling fraction
    # -- calibration-pipeline execution knobs ------------------------------
    # How many calibration batches feed the stats pass (the single source of
    # truth for what used to be ad-hoc calib[:4] / calib[:3] slicing).
    stats_batches: int = 4
    # Mirror-descent steps per jitted lax.scan dispatch; <= 1 keeps the
    # eager one-dispatch-per-step loop (debug / bench baseline).
    scan_chunk: int = 8
    # Microbatches per search step: the task gradient is accumulated over
    # batch-dim slices of each calibration batch, shrinking activation
    # memory at fixed effective batch.  1 = off.
    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind != "train"


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
