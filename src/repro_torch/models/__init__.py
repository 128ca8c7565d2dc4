"""The dense GQA language model of the port (plain dicts of tensors)."""

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
