"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    act="silu", rope_type="none", rwkv_head_dim=64,
    source="arXiv:2404.05892",
)
