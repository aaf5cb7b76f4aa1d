"""Model configuration for the assigned architecture pool (a copy of
``repro.models.config``: plain dataclasses, no framework)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SigHeadConfig:
    """Signature pooling head (the paper's technique as a model component)."""
    channels: int = 8          # path dimension after the learned projection
    depth: int = 3             # truncation depth
    use_logsig: bool = False
    stride: int = 1            # subsample hidden trajectory before signing
    backend: str = "auto"      # engine dispatch (repro_torch.kernels.ops)
    backward: str = "inverse"  # inverse | checkpoint | autodiff
    stream_stride: int = 1     # per-step feature emission stride (sig_stream_features)
    # path transform fused into the signature sweep ("time_augment" /
    # "lead_lag" / "basepoint", "+"-composable; None = sign the raw learned
    # path).  Projected plans must then be over the AUGMENTED alphabet
    # (transform_dim(transform, channels) letters).
    transform: Optional[str] = None
    precision: str = "fp32"    # "fp32" | "bf16_fp32" mixed-precision sweep
    # --- kernel-feature head (repro_torch.sigkernel) ---
    kernel_landmarks: int = 0      # > 0: features are k_ω(path, landmark_j)
    landmark_steps: int = 8        # increments per learned landmark path
    kernel_level_decay: float = 0.5  # level weight λ^n in the gram weighting
    kernel_normalize: bool = True  # RKHS cosine instead of raw k_ω


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # decoder | encdec | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    act: str = "silu"
    attn_bias: bool = False    # qkv bias (qwen1.5)
    qk_norm: bool = False      # qwen3
    rope_theta: float = 1e4
    rope_type: str = "rope"    # rope | mrope | none | sinusoidal
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_layer_start: int = 0       # layers < start are dense
    d_ff_dense: int = 0            # d_ff of dense layers in a MoE model
    capacity_factor: float = 1.25
    moe_group_size: int = 512      # tokens per dispatch group (GShard-style)
    router_aux_coef: float = 0.001
    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- hybrid / ssm ---
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    conv_width: int = 4
    hybrid_attn_every: int = 6     # zamba2: shared attn block cadence
    n_shared_attn_blocks: int = 2  # zamba2: alternating shared blocks
    rwkv_head_dim: int = 64
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500     # encoder positions (stub frontend)
    decoder_max_len: int = 448
    # --- vlm ---
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    # --- paper technique ---
    sig_head: Optional[SigHeadConfig] = None
    # --- notes ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # ------------------------------------------------------------------
    # analytic parameter count (for MODEL_FLOPS = 6·N·D roofline term)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        P = self.vocab_size * d                     # embedding
        if not self.tie_embeddings:
            P += self.vocab_size * d                # lm head

        def attn_params() -> int:
            if self.mla:
                p = d * self.kv_lora_rank + d * self.qk_rope_dim     # kv down
                p += self.kv_lora_rank * nq * (self.qk_nope_dim + self.v_head_dim)
                if self.q_lora_rank:
                    p += d * self.q_lora_rank + self.q_lora_rank * nq * (
                        self.qk_nope_dim + self.qk_rope_dim)
                else:
                    p += d * nq * (self.qk_nope_dim + self.qk_rope_dim)
                p += nq * self.v_head_dim * d                        # out
                return p
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def mlp_params(ff: int) -> int:
            mult = 3 if self.act in ("silu", "swiglu", "geglu") else 2
            return mult * d * ff

        def mamba_params() -> int:
            d_in = self.mamba_expand * d
            nh = d_in // self.mamba_head_dim
            p = d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj (z,x,B,C,dt)
            p += self.conv_width * (d_in + 2 * self.ssm_state)
            p += d_in * d                                   # out proj
            p += 2 * nh                                     # A_log, D
            return p

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,o + decay LoRA; channel-mix: 2 mats
            p = 5 * d * d + 2 * d * 64 + 6 * d
            p += d * self.d_ff + self.d_ff * d + d * d     # channel mix (r,k,v)
            return p

        if self.family == "rwkv":
            P += self.n_layers * rwkv_params()
        elif self.family == "hybrid":
            n_attn = self.n_shared_attn_blocks            # weight-shared
            P += self.n_layers * (mamba_params() + 2 * d)
            P += n_attn * (attn_params() + mlp_params(self.d_ff) + 2 * d)
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff))
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
            P += enc + dec
        else:
            for layer in range(self.n_layers):
                P += attn_params()
                if self.moe and layer >= self.moe_layer_start:
                    P += self.n_experts * mlp_params(self.d_ff_expert)
                    P += self.n_shared_experts * mlp_params(self.d_ff_expert)
                    P += d * self.n_experts                # router
                else:
                    P += mlp_params(self.d_ff_dense or self.d_ff)
        P += self.n_layers * 2 * d                         # norms (approx)
        return P

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.act in ("silu", "swiglu", "geglu") else 2
        n_moe_layers = self.n_layers - self.moe_layer_start
        expert_p = mult * self.d_model * self.d_ff_expert
        inactive = n_moe_layers * (self.n_experts - self.top_k) * expert_p
        return full - inactive
