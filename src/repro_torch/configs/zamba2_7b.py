"""zamba2-7b [hybrid]: Mamba2 backbone + two weight-shared attention blocks
applied every 6 layers (alternating). [arXiv:2411.15242; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    act="silu", rope_theta=1e4,
    ssm_state=64, mamba_head_dim=64, mamba_expand=2, conv_width=4,
    hybrid_attn_every=6, n_shared_attn_blocks=2,
    source="arXiv:2411.15242",
)
