"""llama3-405b [dense]: GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="decoder",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    act="silu", rope_theta=5e5,
    source="arXiv:2407.21783",
)
