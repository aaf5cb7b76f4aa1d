"""command-r-35b [dense]: GQA, no-bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="decoder",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    act="silu", attn_bias=False, rope_theta=8e6, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
