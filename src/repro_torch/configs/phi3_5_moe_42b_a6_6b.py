"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="decoder",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    act="silu", rope_theta=1e4,
    moe=True, n_experts=16, n_shared_experts=0, top_k=2,
    d_ff_expert=6400, moe_layer_start=0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
