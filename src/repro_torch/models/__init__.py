"""The port's language models (plain dicts of tensors): the dense GQA, MLA
(minicpm3), MoE (qwen2-moe, the llama4 interleave), frontend-prefix
(internvl2, musicgen), SSM (mamba2) and hybrid (hymba) families.
``init_params``, ``forward``, ``make_decode_cache``, ``prefill`` and
``decode_step`` take them all."""

from repro_torch.models.lm import (
    decode_step,
    forward,
    init_params,
    make_decode_cache,
    prefill,
)

__all__ = [
    "decode_step",
    "forward",
    "init_params",
    "make_decode_cache",
    "prefill",
]
