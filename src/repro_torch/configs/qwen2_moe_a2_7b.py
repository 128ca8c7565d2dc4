"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) d_ff=1408 vocab=151936.

60 routed experts top-4 (renormalized softmax router) + a 4×-width shared
expert (d_ff = 4·1408 = 5632) gated by a sigmoid shared-gate, per
Qwen1.5-MoE-A2.7B.  QKV bias on, as in the Qwen1.5 family.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,                  # routed expert width
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        num_experts=60,
        num_experts_per_tok=4,
        moe_d_ff=1408,
        shared_expert_d_ff=5632,
        moe_layer_period=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        qkv_bias=True,
        num_experts=6,
        num_experts_per_tok=2,
        moe_d_ff=96,
        shared_expert_d_ff=384,
        moe_layer_period=1,
        dtype="float32",
    )
