"""The tiny model families of the paper-table harness
(``benchmarks/common.py:33-48 FAMILIES``), field for field, kept here so
that the port, its tests and ``chip_smoke.py`` reach them without the
benchmarks package.  Their trained weights are committed as
``results/bench_models/<name>.pkl`` and their unstructured banks as
``results/bench_banks/<name>-unstructured``."""
from repro_torch.configs.base import ModelConfig

FAMILIES: dict[str, ModelConfig] = {
    "llama-tiny": ModelConfig(
        name="llama-tiny", family="dense", d_model=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=512),
    "gemma-tiny": ModelConfig(
        name="gemma-tiny", family="dense", d_model=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=512,
        pattern=("local", "attn"), sliding_window=16, attn_softcap=50.0,
        final_softcap=30.0, sandwich_norm=True, scale_embed=True,
        act="gelu"),
    "moe-tiny": ModelConfig(
        name="moe-tiny", family="moe", d_model=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, moe_d_ff=256,
        vocab_size=512, pattern=("moe",), num_experts=4, top_k=2),
}
