"""qwen1.5-32b [dense]: QKV bias; sheet specifies kv=40 (MHA).
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="decoder",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    act="silu", attn_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B",
)
