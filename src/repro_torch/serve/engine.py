"""Batched serving engine: prefill + greedy decode with RMQ eviction.

The port of ``repro.serve.engine``: greedy decoding over a fixed batch,
with RMQ-backed eviction when the per-sequence importance scores outgrow
the budget.  It takes every family: dense GQA, MLA (minicpm3), MoE
(qwen2-moe, the llama4 interleave), the frontend trunks (internvl2,
musicgen; ``generate`` takes their prefix embeddings), SSM (mamba2) and
hybrid (hymba).  Prefill runs B8 on the card once a GQA attention layer
and B9 once an SSM block (MLA's attention is plain, as the reference
routes it); decode is plain PyTorch (the reference's decode attention is
einsums, its MoE dispatch gathers and einsums, and its SSM step a
one-step recurrence).  An SSM or MLA model adds no attention mass; a
hybrid or period-2 MoE model adds zeros (as in the reference), so their
eviction picks by position.  Eviction runs on
the port's ``StreamingRMQ`` and engine (B3 / B6 / B5 / B4 on the card),
or, with ``serving_tier=``, as the ``kv-eviction`` tenant of a
:class:`repro_torch.serving.ServingTier` (its window batches coalesce
under the tenant's SLO with whatever else the tier serves).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.models.lm import decode_step, prefill
from repro_torch.serve.eviction import RMQEvictionManager

__all__ = ["ServeEngine"]


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        sc: ServeConfig,
        serving_tier: Optional[Any] = None,
    ):
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.device = params["embed"]["w"].device
        self.cache_dtype = getattr(torch, sc.kv_cache_dtype)
        self.eviction = (
            RMQEvictionManager(
                budget=sc.eviction_budget,
                protected_window=sc.eviction_window,
                c=sc.rmq_chunk,
                t=sc.rmq_threshold,
            )
            if sc.eviction_enabled
            else None
        )
        # eviction scans become a tenant of the serving tier
        if self.eviction is not None and serving_tier is not None:
            self.eviction.attach_serving(serving_tier)

    def generate(self, prompt_tokens: torch.Tensor, max_new_tokens: int,
                 prefix_embeddings: Optional[torch.Tensor] = None
                 ) -> Dict[str, Any]:
        """Greedy tokens ``(B, max_new_tokens)``, the final live position
        and the number of evicted cache slots.

        A frontend model's first position is ``frontend_tokens`` past the
        prompt whether or not ``prefix_embeddings`` (B, F, D) are given,
        as in the reference: without them decode attends the F zero slots
        behind the prompt."""
        cfg, seq_len = self.cfg, self.sc.seq_len
        prompt_tokens = torch.as_tensor(prompt_tokens, device=self.device)
        b, s_prompt = prompt_tokens.shape
        f = cfg.frontend_tokens if cfg.frontend else 0
        logits, cache = prefill(cfg, self.params, prompt_tokens,
                                cache_len=seq_len,
                                cache_dtype=self.cache_dtype,
                                prefix_embeddings=prefix_embeddings)
        pos = f + s_prompt
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [token]
        scores = torch.zeros((b, seq_len), dtype=torch.float32,
                             device=self.device)
        slots = torch.arange(seq_len, device=self.device)
        evictions = 0
        # Streaming score index: built once, then kept in sync by batched
        # incremental updates; eviction rounds never rebuild it.
        score_index = None

        for _ in range(max_new_tokens - 1):
            logits, cache, mass = decode_step(
                self.cfg, self.params, token, cache, pos,
                return_attn_mass=self.sc.eviction_enabled)
            if mass is not None:
                scores = scores + mass
            pos += 1
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(token)

            if self.eviction is not None and self.eviction.needs_eviction(
                    pos):
                # Evict on the mean score over the batch (the cache layout
                # is shared, so positions stay aligned); dead slots sync as
                # +inf so they can never be picked.
                mean_scores = torch.where(
                    slots < pos, scores.mean(dim=0),
                    torch.full_like(scores[0], float("inf")))
                if score_index is None:
                    score_index = self.eviction.make_index(
                        seq_len, device=self.device)
                score_index, victims = (
                    self.eviction.plan_evictions_streaming(
                        score_index, mean_scores, pos))
                if victims.shape[0]:
                    cache, scores, pos = self._evict(cache, scores, victims,
                                                     pos)
                    evictions += int(victims.shape[0])

        return {
            "tokens": torch.stack(out, dim=1),
            "final_pos": pos,
            "evicted": evictions,
        }

    def _evict(self, cache, scores, victims, live):
        """Compact live tokens along the cache S axis, shapes static.

        Permutation [kept live rows | old tail | victim rows], built and
        applied with ``index_select`` on the device: victims are parked
        past the live region, where every slot is overwritten by a later
        decode step before it can be attended (decode writes position
        ``pos`` before reading ``col <= pos``).
        """
        seq_len = self.sc.seq_len
        dev = scores.device
        vict = victims.to(device=dev, dtype=torch.int64)
        keep = torch.ones((seq_len,), dtype=torch.bool, device=dev)
        keep[vict] = False
        keep[live:] = False
        keep_idx = torch.cat([
            torch.nonzero(keep).reshape(-1),
            torch.arange(live, seq_len, device=dev),
            vict,
        ])
        new_live = live - int(vict.shape[0])
        # only the attention caches have a position axis: axis 3 of k / v
        # (a period-2 model's layers included), axis 2 of MLA's latent /
        # rope.  An SSM state and conv tail stay as they are (an SSM model
        # permutes nothing, yet its live count falls, as in the reference)
        new_cache = dict(cache)
        for keys, axis in ((("k", "v"), 3), (("latent", "rope"), 2)):
            for key in keys:
                if key in cache:
                    new_cache[key] = torch.index_select(cache[key], axis,
                                                        keep_idx)
        new_scores = torch.index_select(scores, 1, keep_idx)
        # stale rows past the live region must not carry scores
        new_scores = torch.where(
            torch.arange(seq_len, device=dev)[None, :] < new_live,
            new_scores, torch.zeros_like(new_scores))
        return new_cache, new_scores, new_live
