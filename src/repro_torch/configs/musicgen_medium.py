"""musicgen-medium [audio] — 48L d=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec tokens (arXiv:2306.05284).  The
EnCodec tokenizer + 4-codebook delay-pattern embedder is a STUB per the
assignment: the trunk consumes token ids from the 2048-entry codebook
vocab, with an optional prefix of precomputed conditioning embeddings
(the T5 text-conditioning cross-attention is simplified to prefix
conditioning — noted in DESIGN.md §6).  [arXiv:2306.05284; hf]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        frontend="encodec_stub",
        frontend_tokens=64,          # conditioning prefix length
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="audio",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend="encodec_stub",
        frontend_tokens=8,
        dtype="float32",
    )
