"""qwen3-4b [dense]: qk_norm, GQA, head_dim=128. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="decoder",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    act="silu", qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
