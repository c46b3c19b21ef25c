"""Serving step factories: batched prefill + decode over a static cache
(the port of ``repro/serve/step.py``).

``make_serve_step`` builds one decode step: one new token per sequence
against the cache (the SSM state, or the dense family's KV cache, which
is written in place).  A batch holds 'tokens' and, for an M-RoPE model
(qwen2-vl), optionally 'positions' of (B, 3, S) (prefill) or (B, 3, 1)
(decode), as ``configs.specs.input_specs`` gives them; without them the
positions count from the cache's index.  An encdec (whisper) prefill
batch also holds 'frames' (B, enc_seq, d_model): the encoder runs once
there and its cross K/V go into the cache, which the decode steps read.  The steps run eagerly under
``torch.inference_mode``; there is no ``jit`` to build.  A dense cache
made by these steps is an inference tensor: continue it with these steps
(or under ``torch.inference_mode``), since PyTorch refuses an in-place
write to an inference tensor outside that mode.

The steps take a split model (``distributed.tensor_parallel.SplitLM``)
as they take a whole one: tensor parallelism is reached through this API,
with no flag of ``launch/serve.py``, as the reference's dry run reaches
it.  Its cache holds each mesh position's part.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (LM, decode_step, forward, prefill,
                                      serving_cache)


def make_prefill_step(cfg: ModelConfig, max_seq: int,
                      cache_dtype=torch.bfloat16) -> Callable:
    """(params, batch) -> (last_logits, cache).  batch: {'tokens': (B, S)},
    optionally 'positions'; encdec: 'frames' (B, enc_seq, d_model)."""

    @torch.inference_mode()
    def prefill_step(params: LM, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        cache = serving_cache(params, cfg, tokens.shape[0], max_seq,
                              cache_dtype, device=tokens.device)
        logits, cache, _ = forward(params, batch, cfg, cache=cache,
                                   last_only=True)
        return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, cache, batch) -> (logits, new_cache): one decode step."""

    @torch.inference_mode()
    def serve_step(params: LM, cache, batch: Dict[str, torch.Tensor]):
        logits, new_cache, _ = forward(params, batch, cfg, cache=cache)
        return logits, new_cache

    return serve_step


@torch.inference_mode()
def greedy_generate(params: LM, cfg: ModelConfig, prompt: torch.Tensor,
                    n_steps: int, max_seq: Optional[int] = None,
                    frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Simple greedy decoding loop: (B, S) prompt -> (B, n_steps) tokens
    (encdec: after the encoder's pass over ``frames``)."""
    B, S = prompt.shape
    max_seq = max_seq or (S + n_steps)
    logits, cache = prefill(params, prompt, cfg, max_seq, frames=frames)
    out = [torch.argmax(logits[:, -1], dim=-1)]
    for _ in range(n_steps - 1):
        logits, cache = decode_step(params, cache, out[-1][:, None], cfg)
        out.append(torch.argmax(logits[:, -1], dim=-1))
    return torch.stack(out, dim=1)
