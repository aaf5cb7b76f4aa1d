"""deepseek-v2-lite-16b [moe]: MLA kv_lora=512, 64 routed experts top-6 +
2 shared, first layer dense.  The sheet's "160 routed" belongs to full
DeepSeek-V2; V2-Lite is 64 (see DESIGN.md §4). [arXiv:2405.04434; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="decoder",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    act="silu", rope_theta=1e4,
    moe=True, n_experts=64, n_shared_experts=2, top_k=6,
    d_ff_expert=1408, moe_layer_start=1, d_ff_dense=10944,
    mla=True, kv_lora_rank=512, q_lora_rank=0,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    source="arXiv:2405.04434",
)
