"""whisper-large-v3 [audio]: enc-dec; conv/mel frontend is a STUB —
input_specs() supplies precomputed frame embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    act="gelu", rope_type="sinusoidal", tie_embeddings=True,
    n_audio_frames=1500, decoder_max_len=448,
    source="arXiv:2212.04356",
)
