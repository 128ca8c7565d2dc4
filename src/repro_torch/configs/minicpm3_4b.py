"""minicpm3-4b [dense, MLA] — 62L d=2560 40H d_ff=6400 vocab=73448.

Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style):
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
The decode cache stores the 256-wide latent + 32-wide shared rope key per
position instead of per-head K/V — an 11× cache reduction vs. materialized
GQA at this geometry, which is the reason MLA archs shine on the
``decode_32k`` shape.  [hf:openbmb/MiniCPM3-4B; hf]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,            # MLA: every head gets its own K/V view
        head_dim=96,                # qk_nope + qk_rope
        d_ff=6400,
        vocab_size=73448,
        attention_type="mla",
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        d_ff=160,
        vocab_size=512,
        attention_type="mla",
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        tie_embeddings=True,
        dtype="float32",
    )
