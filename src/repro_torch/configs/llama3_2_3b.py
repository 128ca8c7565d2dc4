"""llama3.2-3b [dense] — 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

Standard Llama-3 recipe: RMSNorm, SwiGLU, RoPE theta 500k, no biases.
[hf:meta-llama/Llama-3.2-3B; unverified]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke",
        family="dense",
        num_layers=3,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    )
