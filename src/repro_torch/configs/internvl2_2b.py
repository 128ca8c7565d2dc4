"""internvl2-2b [vlm] — InternLM2 trunk 24L d=2048 16H (GQA kv=8) d_ff=8192.

vocab = 92553.  The InternViT vision frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings
(batch, 256, d_model) that the trunk consumes as a prefix (256 = 16×16
patch tokens after pixel-shuffle, InternVL2's per-tile budget).
[arXiv:2404.16821; hf]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        rope_theta=1_000_000.0,
        frontend="vit_stub",
        frontend_tokens=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        frontend="vit_stub",
        frontend_tokens=16,
        dtype="float32",
    )
