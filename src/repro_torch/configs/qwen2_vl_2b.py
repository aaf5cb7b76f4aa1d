"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution; patch frontend is a stub —
input_specs() supplies precomputed patch/text embeddings.
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="decoder",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    act="silu", attn_bias=True, rope_type="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), tie_embeddings=True,
    source="arXiv:2409.12191",
)
