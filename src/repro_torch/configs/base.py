"""Config dataclasses: model architecture, training and serving.

The port's own copy of ``repro.configs.base`` (pure data; the port imports
nothing of the reference package).  All configs are frozen
dataclasses, hashable and serializable to/from dicts.  One file per assigned
architecture lives next to this module (``repro_torch/configs/<id>.py``)
exposing ``config()`` (exact assigned geometry) and ``smoke_config()``
(reduced same-family geometry for CPU tests).  The port's models run the
dense GQA family and, for training, the SSM family; the others are here as
data and refused by :mod:`repro_torch.models.lm`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "RMQConfig", "ServeConfig", "TrainConfig",
           "registry", "get_config", "get_smoke_config", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    # trunk
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    attention_type: str = "gqa"      # gqa | mla | none
    qkv_bias: bool = False
    parallel_block: bool = False     # Cohere-style parallel attn+FFN
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    global_attn_every: Optional[int] = None   # hybrid: full attn every k-th
    logit_softcap: Optional[float] = None
    # MLA (minicpm3 / deepseek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    moe_layer_period: int = 1        # every k-th layer is MoE (llama4: 2)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # modality frontend (assignment: stubs providing precomputed embeddings)
    frontend: Optional[str] = None   # vit_stub | encodec_stub
    frontend_tokens: int = 0         # prepended embedding positions
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master params

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/head can
        shard over a 16-wide tensor axis (pad ids are never emitted by the
        data pipeline; their logits train toward -inf harmlessly)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.attention_type == "none"

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def num_params(self) -> int:
        """Approximate parameter count (embedding + trunk), for roofline."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        per_layer_attn = 0
        if self.attention_type == "gqa":
            per_layer_attn = (
                d * self.num_heads * self.head_dim * 2  # q, o
                + d * self.num_kv_heads * self.head_dim * 2  # k, v
            )
        elif self.attention_type == "mla":
            qk_dim = self.qk_nope_head_dim + self.qk_rope_head_dim
            per_layer_attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.num_heads * qk_dim
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.num_heads
                * (self.qk_nope_head_dim + self.v_head_dim)
                + self.num_heads * self.v_head_dim * d
            )
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = (
            self.num_experts * 3 * d * self.moe_d_ff
            + (3 * d * self.shared_expert_d_ff
               if self.shared_expert_d_ff else 0)
            + d * self.num_experts
        )
        ssm = 0
        if self.ssm_state:
            di = self.d_inner
            ssm = (
                d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                + di * d + di * self.ssm_conv
            )
        for i in range(self.num_layers):
            if self.attention_type != "none":
                total += per_layer_attn
            if self.family == "hybrid":
                total += ssm
            elif self.ssm_state:
                total += ssm
                continue  # pure SSM: no FFN in mamba2
            is_moe = (
                self.uses_moe
                and (i % self.moe_layer_period == self.moe_layer_period - 1)
            )
            total += moe_ffn if is_moe else dense_ffn
        return total

    def num_active_params(self) -> int:
        """Active (per-token) parameters — 6·N_active·D roofline term."""
        if not self.uses_moe:
            return self.num_params()
        d = self.d_model
        total = self.num_params()
        # replace full expert block with top-k + shared
        moe_layers = self.num_layers // self.moe_layer_period
        all_experts = moe_layers * self.num_experts * 3 * d * self.moe_d_ff
        active = moe_layers * self.num_experts_per_tok * 3 * d * self.moe_d_ff
        return total - all_experts + active


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seq_len: int = 4096
    global_batch: int = 256
    microbatches: int = 1            # grad accumulation
    remat_policy: str = "minimal"    # none | minimal | full | names
    optimizer_state_dtype: str = "float32"   # float32 | bfloat16
    grad_allreduce_dtype: str = "bfloat16"   # gradient compression knob
    loss_chunk: int = 0              # >0: chunked xent, logits never full
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    seq_len: int = 32768             # KV cache length
    batch: int = 128
    kv_cache_dtype: str = "bfloat16"
    # RMQ-backed eviction (the paper's technique as a serving feature)
    eviction_enabled: bool = False
    eviction_budget: int = 0         # keep at most this many tokens
    eviction_window: int = 1024      # protected recent window
    rmq_chunk: int = 128
    rmq_threshold: int = 16


@dataclasses.dataclass(frozen=True)
class RMQConfig:
    """Standalone RMQ product surface config (paper §5.3 tuning);
    ``backend="auto"`` is the device's (``cuda`` on a card, ``eager``
    on the CPU)."""
    c: int = 128
    t: int = 64
    query_block: int = 256
    with_positions: bool = False
    backend: str = "auto"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "qwen2-moe-a2.7b",
    "internvl2-2b",
    "command-r-plus-104b",
    "qwen1.5-0.5b",
    "llama3.2-3b",
    "minicpm3-4b",
    "musicgen-medium",
    "mamba2-1.3b",
    "hymba-1.5b",
)

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "internvl2-2b": "internvl2_2b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "llama3.2-3b": "llama3_2_3b",
    "minicpm3-4b": "minicpm3_4b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-1.3b": "mamba2_1_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def registry():
    return dict(_MODULES)


def _module(arch: str):
    import importlib

    if arch not in _MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_MODULES)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
