"""Gemma-2 2B: local/global alternation, logit softcaps, sandwich norms
[arXiv:2408.00118; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense", d_model=2304, num_layers=26,
    num_heads=8, num_kv_heads=4, head_dim=256, d_ff=9216, vocab_size=256000,
    pattern=("local", "attn"), sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
    scale_embed=True, act="gelu", tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=4, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, sliding_window=16)
