"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) vocab=202048.

MoE: 128 routed experts top-1 + 1 shared expert, **interleaved every 2nd
layer** (Llama-4 Maverick's interleave_moe_layer_step=2).  With all-layer
MoE the expert params alone would be ~770B; period-2 lands at ~400B total
/ ~17B active, matching the model name (DESIGN.md §6).  Dense layers use
d_ff = 16384 (2× the expert width, per Llama-4); routed/shared experts use
the assigned d_ff = 8192.  [hf:meta-llama/Llama-4 family; unverified]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,                 # dense (non-MoE) layers
        vocab_size=202048,
        rope_theta=500_000.0,
        num_experts=128,
        num_experts_per_tok=1,
        moe_d_ff=8192,
        shared_expert_d_ff=8192,
        moe_layer_period=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        num_experts=8,
        num_experts_per_tok=1,
        moe_d_ff=128,
        shared_expert_d_ff=128,
        moe_layer_period=2,
        dtype="float32",
    )
