"""mamba2-1.3b [ssm] — 48L d=2048 attention-free, vocab=50280, d_state=128.

SSD (state-space duality, arXiv:2405.21060): d_inner = 2·d_model = 4096,
headdim = 64 ⇒ 64 SSD heads, ngroups = 1, conv4.  The chunked SSD scan is
the CUDA kernel B9 in ``repro_torch.kernels.ssd_scan``.

§Arch-applicability (DESIGN.md): the paper's RMQ-backed KV eviction is
INAPPLICABLE here — constant-size SSM state, no per-token cache, no
attention scores.  Implemented without the technique, as assigned.
``long_500k`` RUNS for this arch (O(1)-state decode).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        attention_type="none",
        ssm_state=128,
        ssm_heads=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=128,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        attention_type="none",
        ssm_state=16,
        ssm_heads=4,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=32,
        tie_embeddings=True,
        dtype="float32",
    )
