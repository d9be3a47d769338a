"""AdamW with warmup-cosine schedule and global-norm clipping: the JAX
package's ``training/optimizer.py`` over the port's parameters.

``adamw_bf16`` stores both moments in bfloat16; ``adafactor`` keeps a
bf16 momentum and a factored second moment.  Update math runs in float32.

Parameters, gradients and moments are dicts keyed by the port's parameter
names (``model.named_parameters()``), one tensor per layer.  The JAX tree
instead stacks each period position's layers on a leading axis
(``layers.pos{p}``, the encoder's ``enc_layers.pos0``), so a layer's
leaf has one more dimension there: a norm scale is (P, d) in JAX and (d,)
here.  Three rules read a leaf's rank, and the port applies each to the
JAX rank (:func:`jax_ndim`), not its own:

* weight decay applies to leaves of rank >= 2 (every layer's norms and
  Mamba vectors, not ``final_norm``);
* the train step's bf16 compute copies are made of float32 leaves of rank
  >= 2 (``train_loop.cast_compute``);
* Adafactor factors the trailing two dims, so a stacked 1-D leaf (P, d)
  keeps one ``row`` value a layer and one ``col`` vector for all the
  layers of its period position.  Here each such layer holds its ``row``
  (a 0-dim tensor) and a ``col`` that every update writes alike across
  the group, and the update reads the group together
  (:func:`stacked_leaf`).

Leaves of rank >= 2 per layer (the qkv biases among them) factor per layer
on both sides.  ``apply_updates`` updates the parameters and the state in
place.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import RunConfig

State = Union[torch.Tensor, Dict[str, torch.Tensor]]
_STACKS = ("layers", "enc_layers")


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, State]      # a factored entry is {"row", "col"}
    step: torch.Tensor       # int32 ()


def stacked_leaf(name: str, period: int) -> Tuple[str, Optional[int]]:
    """The JAX leaf that holds port parameter ``name`` and its index on the
    leaf's stacking axis (None for an unstacked leaf): layer i of the
    decoder is ``layers.pos{i % period}`` at i // period, layer i of the
    encoder (period 1) ``enc_layers.pos0`` at i; e.g.
    ``layers.5.attn.wq`` with period 2 → (``layers.pos1.attn.wq``, 2)."""
    head, _, rest = name.partition(".")
    if head not in _STACKS:
        return name, None
    i, _, leaf = rest.partition(".")
    p = period if head == "layers" else 1
    return f"{head}.pos{int(i) % p}.{leaf}", int(i) // p


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of ``name``'s leaf in the JAX tree: one more than the
    port's for a layer's parameter."""
    return t.ndim + (name.partition(".")[0] in _STACKS)


def lr_schedule(step, rc: RunConfig, total_steps: int = 100_000
                ) -> torch.Tensor:
    """Linear warmup over ``rc.warmup_steps``, then a cosine to 0.1 x
    ``rc.learning_rate`` at ``total_steps`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(rc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - rc.warmup_steps)
                       / max(total_steps - rc.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return rc.learning_rate * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Dict[str, torch.Tensor], rc: RunConfig
                   ) -> OptState:
    """Zero moments beside ``params``: float32 (``adamw``), bfloat16
    (``adamw_bf16``), or a bf16 momentum and a factored float32 second
    moment for leaves of JAX rank >= 2 (``adafactor``)."""
    dev = next(iter(params.values())).device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if rc.optimizer == "adafactor":
        return OptState(
            m={n: torch.zeros_like(p, dtype=torch.bfloat16)
               for n, p in params.items()},
            v={n: _fact_init_v(n, p) for n, p in params.items()}, step=step)
    dt = torch.bfloat16 if rc.optimizer == "adamw_bf16" else torch.float32
    return OptState(m={n: torch.zeros_like(p, dtype=dt)
                       for n, p in params.items()},
                    v={n: torch.zeros_like(p, dtype=dt)
                       for n, p in params.items()}, step=step)


def _fact_init_v(name: str, p: torch.Tensor) -> State:
    f32 = dict(dtype=torch.float32, device=p.device)
    if jax_ndim(name, p) < 2:
        return torch.zeros(p.shape, **f32)
    # row/col over the leaf's trailing two dims: a stacked 1-D leaf's row
    # is one value per layer, its col the group's (every layer a copy)
    if p.ndim == 1:
        return {"row": torch.zeros((), **f32), "col": torch.zeros(p.shape,
                                                                   **f32)}
    return {"row": torch.zeros(p.shape[:-1], **f32),
            "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}


def _fact_update_v(v: Dict[str, torch.Tensor], g2: torch.Tensor, b2: float):
    """The JAX package's factored update on (.., a, b) gradients squared."""
    row = v["row"] * b2 + (1 - b2) * g2.mean(-1)
    col = v["col"] * b2 + (1 - b2) * g2.mean(-2)
    denom = torch.clamp(row.mean(-1, keepdim=True), min=1e-30)
    vhat = (row[..., None] * col[..., None, :]) / denom[..., None]
    return {"row": row, "col": col}, vhat


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], opt: OptState,
                  rc: RunConfig, *, period: int = 1, b1: float = 0.9,
                  b2: float = 0.95, eps: float = 1e-8
                  ) -> Tuple[Dict[str, torch.Tensor], OptState,
                             Dict[str, torch.Tensor]]:
    """One optimizer step, in place: clip ``grads`` to ``rc.grad_clip`` by
    their global norm, update the moments and the parameters (decoupled
    weight decay on leaves of JAX rank >= 2).  ``period`` is the model's
    (``cfg.period``): it groups the layers into JAX's stacked leaves for
    Adafactor.  Returns (params, the state, {"grad_norm", "lr"}), both
    updated in place (the state's step too)."""
    step = opt.step
    step.add_(1)
    gnorm = global_norm(grads)
    clip = torch.clamp(rc.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_schedule(step, rc)
    sf = step.to(torch.float32)
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    factored = rc.optimizer == "adafactor"

    def finish(name, m32, vhat):
        p = params[name]
        mhat = m32 / c1
        vhat = vhat / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if jax_ndim(name, p) >= 2:       # decoupled decay on matrices only
            delta = delta + rc.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        opt.m[name].copy_(m32)

    groups: Dict[str, List[str]] = {}
    with torch.no_grad():
        for name, p in params.items():
            v = opt.v[name]
            if factored and isinstance(v, dict) and p.ndim == 1:
                groups.setdefault(stacked_leaf(name, period)[0],
                                  []).append(name)
                continue
            g = grads[name].to(torch.float32) * clip
            m32 = opt.m[name].to(torch.float32) * b1 + (1 - b1) * g
            if isinstance(v, dict):
                v_new, vhat = _fact_update_v(v, g * g, b2)
                v["row"].copy_(v_new["row"])
                v["col"].copy_(v_new["col"])
            else:
                vhat = v.to(torch.float32) * b2 + (1 - b2) * g * g
                v.copy_(vhat)
            finish(name, m32, vhat)
        # stacked 1-D leaves under Adafactor: the group's (P, d) at once
        for names in groups.values():
            g = torch.stack([grads[n].to(torch.float32)
                             for n in names]) * clip
            m32 = torch.stack([opt.m[n].to(torch.float32)
                               for n in names]) * b1 + (1 - b1) * g
            v_new, vhat = _fact_update_v(
                {"row": torch.stack([opt.v[n]["row"] for n in names]),
                 "col": opt.v[names[0]]["col"]}, g * g, b2)
            for j, n in enumerate(names):
                opt.v[n]["row"].copy_(v_new["row"][j])
                opt.v[n]["col"].copy_(v_new["col"])
                finish(n, m32[j], vhat[j])
    return params, opt, {"grad_norm": gnorm, "lr": lr}
