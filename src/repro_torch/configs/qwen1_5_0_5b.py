"""qwen1.5-0.5b [dense] — 24L d=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.

QKV bias enabled (Qwen1.5 family trait); tied embeddings (the 0.5B ties
lm_head to the input embedding).  [hf:Qwen/Qwen1.5-0.5B; hf]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        dtype="float32",
    )
