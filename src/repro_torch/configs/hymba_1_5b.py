"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) d_ff=5504, d_state=16.

Parallel attention + mamba heads within each layer (arXiv:2411.13676):
both paths read the same normed input; outputs are per-path RMSNormed,
scaled by learned β vectors, and mean-fused.  The SSM path mirrors the
attention width (d_inner = d_model = 1600 ⇒ 25 SSD heads × 64).
Attention is SWA(1024) except every 8th layer, which is global — carried
as per-layer scanned window data.  Hymba's 128 meta tokens are represented
by the frontend-prefix mechanism (learnable prompt prefix ≡ precomputed
embeddings; stubbed like the other frontends, noted in DESIGN.md §6).

``long_500k`` RUNS for this arch: SWA + constant SSM state keep decode
sub-quadratic.  [arXiv:2411.13676; hf]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        sliding_window=1024,
        global_attn_every=8,
        ssm_state=16,
        ssm_heads=25,
        ssm_head_dim=64,
        ssm_expand=1,               # SSM path mirrors attention width
        ssm_conv=4,
        ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=16,
        global_attn_every=2,
        ssm_state=8,
        ssm_heads=4,
        ssm_head_dim=16,
        ssm_expand=1,
        ssm_conv=4,
        ssm_chunk=16,
        dtype="float32",
    )
