"""DeepSeek-V2-Lite 16B: MLA (kv_lora=512) + 2 shared / 64 routed top-6 MoE,
first layer dense (d_ff 10944) [arXiv:2405.04434; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", d_model=2048, num_layers=27,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=10944,
    vocab_size=102400, pattern=("mla_moe",), pattern_prefix=("mla_dense",),
    kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    num_experts=64, top_k=6, moe_d_ff=1408, num_shared_experts=2,
    tie_embeddings=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=3, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, moe_d_ff=64, vocab_size=512, kv_lora=32,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32, num_experts=8, top_k=2,
    num_shared_experts=1)
