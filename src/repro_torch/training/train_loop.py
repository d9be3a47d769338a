"""Training step: microbatch gradient accumulation, bf16 compute copies,
remat, compression (the JAX package's ``training/train_loop.py``).

``make_train_step`` builds the step

    (model, opt_state, ef_state, batch) → (model, opt_state, ef, metrics)

over the model's own parameters as float32 masters, updated in place.
The global batch is split into ``rc.microbatches`` microbatches, a
Python loop where the JAX package scans; each runs the model through
``torch.func.functional_call`` on bf16 compute copies of the masters
(:func:`cast_compute`), so the gradient of each copy lands on its
master, and accumulates in ``rc.accum_dtype``.  The accumulated gradients
are divided by k, optionally sent through ``ef_compress``, and applied.
Each layer is checkpointed by ``rc.remat`` (``Transformer.forward``).

No kernel has a backward: a train step in a sparse mode with
``sparse_use_kernel`` raises ``NotImplementedError``, as ``jax.grad``
raises through ``pallas_call``.  Dense mode, and the sparse modes
without the kernel, train (the latter with the dense gradients).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import compression as comp
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt

Tensors = Dict[str, torch.Tensor]


def split_micro(batch: Tensors, k: int) -> Tensors:
    """(B, ...) → (k, B // k, ...) for every tensor of the batch."""
    def split(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} is not a multiple of {k} "
                             "microbatches")
        return x.reshape(k, b // k, *x.shape[1:])
    return {key: split(x) for key, x in batch.items()}


def cast_compute(params: Tensors, rc: RunConfig) -> Tensors:
    """With bf16 activations, bf16 copies of the float32 leaves of JAX
    rank >= 2 (:func:`~repro_torch.training.optimizer.jax_ndim`: a layer's
    norm scales too); the rest as they are."""
    if rc.act_dtype != "bfloat16":
        return dict(params)
    return {n: (w.to(torch.bfloat16) if w.dtype == torch.float32
                and opt.jax_ndim(n, w) >= 2 else w)
            for n, w in params.items()}


def make_grad_fn(cfg: ModelConfig, rc: RunConfig):
    """``grad_fn(model, batch) -> (grads, loss)``: the gradients of
    :func:`~repro_torch.models.transformer.lm_loss` with respect to the
    model's parameters, summed over ``rc.microbatches`` microbatches in
    ``rc.accum_dtype`` and divided by their count, and the mean of the
    microbatches' losses (float32)."""
    acc_dt = (torch.bfloat16 if rc.accum_dtype == "bfloat16"
              else torch.float32)

    def grad_fn(model: tfm.Transformer, batch: Tensors
                ) -> Tuple[Tensors, torch.Tensor]:
        k = rc.microbatches
        micro = split_micro(batch, k)
        masters = dict(model.named_parameters())
        names = list(masters)
        acc: Optional[Tensors] = None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(masters.values())).device)
        for i in range(k):
            mb = {key: x[i] for key, x in micro.items()}
            total, metrics = tfm.loss_of(functional_call(
                model, cast_compute(masters, rc), (mb, cfg), {"rc": rc}),
                mb["labels"])
            g = torch.autograd.grad(total, [masters[n] for n in names],
                                    allow_unused=True)
            g = {n: (torch.zeros_like(masters[n]) if gi is None else gi)
                 for n, gi in zip(names, g)}
            if acc is None:      # zeros + g is g
                acc = {n: gi.to(acc_dt) for n, gi in g.items()}
            else:
                for n, gi in g.items():
                    acc[n].add_(gi.to(acc_dt))
            loss_sum = loss_sum + metrics["loss"].detach()
            del g, total, metrics
        for a in acc.values():
            a.div_(k)
        return acc, loss_sum / k

    return grad_fn


def make_train_step(cfg: ModelConfig, rc: RunConfig, *,
                    compress_grads: bool = False):
    """The train step for (cfg, rc): its metrics are ``loss`` (the mean of
    the microbatches' losses), ``grad_norm`` (before clipping) and ``lr``.
    It turns the model's parameters trainable (``requires_grad_``)."""
    grad_fn = make_grad_fn(cfg, rc)

    def train_step(model: tfm.Transformer, opt_state: opt.OptState,
                   ef: Optional[Any], batch: Tensors):
        model.requires_grad_(True)
        grads, loss = grad_fn(model, batch)
        if compress_grads:
            grads, ef = comp.ef_compress(grads, ef)
        params = dict(model.named_parameters())
        _, opt_state, om = opt.apply_updates(params, grads, opt_state, rc,
                                             period=cfg.period)
        return model, opt_state, ef, {"loss": loss, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, rc: RunConfig):
    """``eval_step(model, batch) -> metrics`` of ``lm_loss``, without
    autograd."""
    @torch.no_grad()
    def eval_step(model: tfm.Transformer, batch: Tensors):
        _, metrics = tfm.lm_loss(model, batch, cfg, rc=rc)
        return metrics
    return eval_step


def state_tree(model: tfm.Transformer, opt_state: opt.OptState) -> Dict:
    """What a checkpoint holds: {"params", "m", "v", "step"}, keyed by the
    model's parameter names."""
    return {"params": dict(model.named_parameters()), "m": opt_state.m,
            "v": opt_state.v, "step": opt_state.step}


def load_state(model: tfm.Transformer, tree: Dict) -> opt.OptState:
    """Copy a restored :func:`state_tree` into ``model``'s parameters and
    return its optimizer state."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tree["params"][n])
    return opt.OptState(m=tree["m"], v=tree["v"], step=tree["step"])
