"""The port's language models (plain dicts of tensors): the dense GQA, SSM
(mamba2) and hybrid (hymba) families.  ``init_params``, ``forward``,
``make_decode_cache``, ``prefill`` and ``decode_step`` take all three;
MoE, MLA and the modality frontends raise ``NotImplementedError``
(ROADMAP A12)."""

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
