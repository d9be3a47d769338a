"""Prefill / decode steps and the greedy ``generate`` loop.

The JAX package scans its decode steps with ``lax.scan``; here they are a
Python loop, so every step runs eagerly (and a stats tape sees them all).
An encoder-decoder's ``batch["mel"]`` goes to the prefill only: the
encoder runs once, and decode reads the memory's K/V from the cross
caches.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import device as devmod
from repro_torch.models import transformer as tfm


class DecodeState(NamedTuple):
    caches: List               # per decoder layer: KVCache, EncDecCache
                               # or (a Mamba layer) SSMState
    last_token: torch.Tensor   # (B, 1) int64
    pos: int                   # next position to write


def make_prefill_step(cfg: ModelConfig, rc: Optional[RunConfig] = None):
    def prefill(model: tfm.Transformer, batch: Dict[str, torch.Tensor],
                caches: List):
        tokens = batch["tokens"]
        s = tokens.shape[1]
        out = model(batch, cfg, caches=caches,
                    positions=torch.arange(s, device=tokens.device), rc=rc)
        next_tok = out.logits[:, -1:].argmax(-1)
        return DecodeState(caches=out.caches, last_token=next_tok,
                           pos=s), out.logits

    return prefill


def make_decode_step(cfg: ModelConfig, rc: Optional[RunConfig] = None):
    def decode(model: tfm.Transformer, state: DecodeState):
        tok = state.last_token
        out = model({"tokens": tok}, cfg, caches=state.caches,
                    positions=torch.tensor([state.pos], device=tok.device),
                    rc=rc)
        logits = out.logits[:, 0]
        nxt = logits.argmax(-1)[:, None]
        return DecodeState(caches=out.caches, last_token=nxt,
                           pos=state.pos + 1), logits

    return decode


def generate(model: tfm.Transformer, batch: Dict[str, torch.Tensor],
             cfg: ModelConfig, *, max_new_tokens: int,
             capacity: Optional[int] = None, rc: Optional[RunConfig] = None,
             device=None) -> torch.Tensor:
    """Greedy generation: prefill, then ``max_new_tokens - 1`` decode steps.

    Returns exactly ``max_new_tokens`` int32 tokens per row (the
    prefill's argmax is the first).  ``batch``: {"tokens": (B, S)}, plus
    "mel" (B, T, n_mels) for an encoder-decoder, which only the prefill
    sees.  ``rc.kv_quant`` makes the caches int8.  ``device=None`` means
    the card; the model must live on ``device``.
    """
    dev = devmod.resolve(device)
    devmod.check_on(model.embed, dev, "the model")
    tokens = batch["tokens"].to(dev)
    first = {"tokens": tokens}
    if "mel" in batch:
        first["mel"] = batch["mel"].to(dev)
    b, s = tokens.shape
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    caches = tfm.init_caches(cfg, b, capacity or (s + max_new_tokens),
                             quantized=bool(rc and rc.kv_quant), device=dev)
    prefill = make_prefill_step(cfg, rc)
    decode = make_decode_step(cfg, rc)
    state, _ = prefill(model, first, caches)
    out = [state.last_token[:, 0]]
    for _ in range(max_new_tokens - 1):
        state, _ = decode(model, state)
        out.append(state.last_token[:, 0])
    return torch.stack(out, dim=1).to(torch.int32)
