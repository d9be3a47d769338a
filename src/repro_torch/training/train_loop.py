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

On a mesh (``make_train_step(..., param_pspecs=, mesh=)``, the launcher's
placement by the train rules) every float32 master, its moments and its
gradient are the rank's block under its spec
(``sharding.shard_params_``).  A step casts each block to its compute
copy (bf16 by the JAX rank, as above), so the copy keeps the master's
spec, and gathers it whole (``sharding.gather_slices``): the gather moves
bf16.  A MoE layer's weights are the exception: they are resharded to
the sharded MoE's own specs and it runs its own collectives.  Each
microbatch (rows ``[i·B/k, (i+1)·B/k)`` of the global batch) gives every
rank its block of rows over the batch axes (``sharding.batch_axes``, the
largest run of them whose size divides the microbatch's rows);
the ranks along the other axes compute the same rows.  Gradients
accumulate whole in ``rc.accum_dtype`` over the microbatches and are
reduced once a step: the whole copies' summed over the batch axes (the
MoE's collectives sum its own), every one divided by the microbatches
and the batch axes' size and cut to the master's block.  (The JAX
package's XLA reduce-scatters each microbatch beside the next backward;
over gloo, eight reductions a step cost traffic L 8× the time of one.)
The rank's loss is weighted by its share of the microbatch's tokens, so
the sum is the gradient of the microbatch's mean loss.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import comm
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.models import moe as moem
from repro_torch.models import nn as tnn
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


def _cast(n: str, w: torch.Tensor, rc: RunConfig) -> torch.Tensor:
    if (rc.act_dtype == "bfloat16" and w.dtype == torch.float32
            and opt.jax_ndim(n, w) >= 2):
        return w.to(torch.bfloat16)
    return w


def cast_compute(params: Tensors, rc: RunConfig) -> Tensors:
    """With bf16 activations, bf16 copies of the float32 leaves of JAX
    rank >= 2 (:func:`~repro_torch.training.optimizer.jax_ndim`: a layer's
    norm scales too); the rest as they are.  On a mesh each copy is cast
    from the master's block, so it keeps the master's spec."""
    return {n: _cast(n, w, rc) for n, w in params.items()}


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


def _moe_block_specs(model: tfm.Transformer) -> Dict[str, Any]:
    """{parameter name: the spec its block takes in the sharded MoE} for
    every MoE layer marked for a mesh (``moe.shard``)."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, moem.MoE) and module.shard is not None:
            for key, spec in module.shard.specs.items():
                out[f"{name}.{key}"] = spec
    return out


def make_sharded_grad_fn(cfg: ModelConfig, rc: RunConfig,
                         param_pspecs: Dict[str, Any], mesh):
    """``grad_fn(model, batch) -> (grads, loss)`` on ``mesh``, under the
    current rules: ``model`` holds the rank's blocks under
    ``param_pspecs`` and ``batch`` the global batch.  ``grads`` are the
    blocks of the microbatches' mean gradient, in ``rc.accum_dtype``;
    ``loss`` the mean of the microbatches' losses over the whole batch
    (see the module docstring)."""
    acc_dt = (torch.bfloat16 if rc.accum_dtype == "bfloat16"
              else torch.float32)

    def grad_fn(model: tfm.Transformer, batch: Tensors
                ) -> Tuple[Tensors, torch.Tensor]:
        rules = tnn.current_rules()
        k = rc.microbatches
        micro = split_micro(batch, k)
        rows = next(iter(micro.values())).shape[1]
        # the batch axes that split a microbatch's rows: the largest run of
        # them whose size divides the rows (16 rows on ("pod", "data") =
        # 2×16 split over "data"; the ranks along "pod" repeat them), as
        # the JAX package's shape-aware specs fall back
        axes = shd._best_divisible(shd.batch_axes(rules, mesh), rows,
                                   shd.mesh_sizes(mesh))
        dp = shd.axes_size(mesh, axes)
        g_dp = comm.axis_group(mesh, axes) if dp > 1 else None
        lo, hi = shd.block_range(rows, shd._entry(axes), mesh)
        masters = dict(model.named_parameters())
        names = list(masters)
        in_moe = _moe_block_specs(model)
        with torch.no_grad():
            # the compute copies: cast from the blocks, then gathered
            leaves = {}
            for n, w in masters.items():
                c = _cast(n, w, rc)
                c = (shd.reshard(c, param_pspecs[n], in_moe[n], mesh)
                     if n in in_moe else
                     shd.gather_slices(c, param_pspecs[n], mesh))
                leaves[n] = c.detach().requires_grad_(True)
        acc: Tensors = {}
        dev = next(iter(masters.values())).device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with tnn.local_batch(axes):
            for i in range(k):
                mb = {key: x[i, lo:hi] for key, x in micro.items()}
                # this rank's share of the microbatch's tokens, times dp:
                # device tensors, so that the step reads no value back
                tokens = (micro["labels"][i] >= 0).sum(dtype=torch.float64)
                share = ((mb["labels"] >= 0).sum(dtype=torch.float64)
                         / tokens.clamp(min=1.0))
                total, metrics = tfm.loss_of(functional_call(
                    model, leaves, (mb, cfg), {"rc": rc}), mb["labels"])
                w = (share * dp).to(torch.float32)
                share = share.to(torch.float32)
                obj = total + (w - 1) * metrics["loss"]
                g = list(torch.autograd.grad(
                    obj, [leaves[n] for n in names], allow_unused=True))
                loss_sum = loss_sum + metrics["loss"].detach() * share
                del total, obj, metrics
                for j, n in enumerate(names):
                    # each gradient freed once added: four ranks of whole
                    # copies, their gradients and whole accumulators share
                    # one card in traffic L
                    gi, g[j] = g[j], None
                    if gi is None:
                        gi = torch.zeros_like(leaves[n])
                    if n in acc:
                        acc[n].add_(gi.to(acc_dt))
                    else:
                        acc[n] = gi.to(acc_dt)
                    del gi
                del g
        del leaves
        grads = {}
        with torch.no_grad():
            for n in names:
                a = acc.pop(n).div_(k)
                if n in in_moe:
                    # the MoE's collectives summed it over the data blocks
                    a = shd.reshard(a, in_moe[n], param_pspecs[n], mesh)
                else:
                    a = shd.local_slice(comm.all_reduce(
                        a.to(torch.float32), g_dp), param_pspecs[n], mesh)
                grads[n] = (a / dp).to(acc_dt).contiguous()
            loss = comm.all_reduce(loss_sum, g_dp) / k
        return grads, loss

    return grad_fn


def make_train_step(cfg: ModelConfig, rc: RunConfig, *,
                    compress_grads: bool = False,
                    param_pspecs: Optional[Dict[str, Any]] = None,
                    mesh=None):
    """The train step for (cfg, rc): its metrics are ``loss`` (the mean of
    the microbatches' losses), ``grad_norm`` (before clipping) and ``lr``.
    It turns the model's parameters trainable (``requires_grad_``).

    With ``mesh`` the model holds the rank's blocks under
    ``param_pspecs`` (``sharding.shard_params_``), as do the optimizer
    and error-feedback states, and the step takes the global batch and
    runs under ``nn.axis_rules`` with the rules in force when it is
    called (the train rules when none are)."""
    if mesh is None:
        grad_fn = make_grad_fn(cfg, rc)
    else:
        grad_fn = make_sharded_grad_fn(cfg, rc, param_pspecs, mesh)

    def train_step(model: tfm.Transformer, opt_state: opt.OptState,
                   ef: Optional[Any], batch: Tensors):
        model.requires_grad_(True)
        if mesh is None:
            return _update(model, opt_state, ef, *grad_fn(model, batch))
        rules = tnn.current_rules() or shd.make_rules("train")
        with tnn.axis_rules(rules, mesh=mesh):
            return _update(model, opt_state, ef, *grad_fn(model, batch))

    def _update(model, opt_state, ef, grads, loss):
        place = {} if mesh is None else dict(specs=param_pspecs, mesh=mesh)
        if compress_grads:
            grads, ef = comp.ef_compress(grads, ef, **place)
        params = dict(model.named_parameters())
        _, opt_state, om = opt.apply_updates(params, grads, opt_state, rc,
                                             period=cfg.period, **place)
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
    model's parameter names (on a mesh, the rank's blocks)."""
    return {"params": dict(model.named_parameters()), "m": opt_state.m,
            "v": opt_state.v, "step": opt_state.step}


def state_pspecs(param_pspecs: Dict[str, Any], opt_state: opt.OptState
                 ) -> Dict:
    """The specs of :func:`state_tree`'s leaves (a factored second
    moment's ``row``/``col`` too): the shardings of a sharded save and
    of an elastic restore."""
    return {"params": param_pspecs,
            **shd.opt_state_pspecs(param_pspecs, opt_state.v)}


def load_state(model: tfm.Transformer, tree: Dict) -> opt.OptState:
    """Copy a restored :func:`state_tree` into ``model``'s parameters (on
    a mesh, the rank's blocks) and return its optimizer state."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tree["params"][n])
    return opt.OptState(m=tree["m"], v=tree["v"], step=tree["step"])
