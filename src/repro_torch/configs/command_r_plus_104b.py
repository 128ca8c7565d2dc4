"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) d_ff=33792.

vocab = 256000, no biases, Cohere-style **parallel attention+FFN block**
(one shared input norm; attention and FFN both read it, residual adds
both).  [hf:CohereForAI/c4ai-command-r-plus; unverified]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256000,
        parallel_block=True,
        rope_theta=75_000_000.0,
        tie_embeddings=True,       # command-r ties input/output embeddings
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-smoke",
        family="dense",
        num_layers=3,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        parallel_block=True,
        tie_embeddings=True,
        dtype="float32",
    )
