"""xLSTM-125M: alternating mLSTM / sLSTM blocks [arXiv:2405.04517]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", d_model=768, num_layers=12,
    num_heads=4, num_kv_heads=4, head_dim=192, d_ff=0, vocab_size=50304,
    pattern=("mlstm", "slstm"), lstm_heads=4, lstm_proj_factor=2.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=64, num_layers=4, num_heads=2, num_kv_heads=2,
    head_dim=32, vocab_size=512, lstm_heads=2)
