"""Mamba2 / SSD (state-space duality) block: the JAX package's
``models/ssm.py``.

The SSD block decomposition (Dao & Gu, 2024) computes the selective-SSM
recurrence as intra-chunk quadratic ("attention-like") products plus an
inter-chunk recurrence over chunk summaries; decode is the O(1) state
update ``h <- h * exp(dt * A) + dt * B x^T``, ``y = C h + D x``.  Used
alone for mamba2-370m and interleaved 1:7 with attention for
jamba-1.5-large.

The reference writes the scan in plain ``jnp`` (no Pallas kernel), and
so does this module in plain torch.  Its products are pairwise, in an
order whose largest intermediate is one (B, NC, G, Hg, P, N) chunk-state
tensor: at jamba's width the reference's three-operand einsums would form
a (B, NC, L, H, P, N) float32 tensor of tens of GB.  The scan and the
conv run in float32 (the conv as a shift-and-add, never a TF32
convolution), and the casts are the reference's: the D-residual is added
in float32 before the one cast to the activation dtype, so that a
prefill and the decode steps after it agree.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.nn import rms_norm

DT_LIMIT = 20.0


class SSMState(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) float32 SSM state
    conv: torch.Tensor    # (B, K-1, conv_dim) causal-conv tail


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_state(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16,
               device=None) -> SSMState:
    """A zero state for ``batch`` rows: float32 SSM state, the conv tail
    in ``dtype`` (the caches' dtype, as in the JAX package)."""
    return SSMState(
        state=torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state, dtype=torch.float32, device=device),
        conv=torch.zeros(batch, cfg.ssm_conv - 1, conv_dim(cfg), dtype=dtype,
                         device=device))


class Mamba(nn.Module):
    """in_proj (d, 2·d_inner + 2·G·N + H), conv_w (K, conv_dim), conv_b
    (conv_dim,), dt_bias / A_log / D (H,), norm (d_inner,), out_proj
    (d_inner, d): the JAX package's parameter dict."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, din = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        cdim = conv_dim(cfg)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device,
                                            dtype=dtype), requires_grad=False)
        self.in_proj = param(d, 2 * din + 2 * g * n + h)
        self.conv_w = param(cfg.ssm_conv, cdim)
        self.conv_b = param(cdim)
        self.dt_bias = param(h)
        self.A_log = param(h)
        self.D = param(h)
        self.norm = param(din)
        self.out_proj = param(din, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: normal projections (stddev
        fan-in^-0.5) and conv weights (0.1), A_log = log(linspace(1, 16,
        H)), zero conv bias and dt bias, unit D and norm."""
        d, din = self.in_proj.shape[0], self.out_proj.shape[0]
        h = self.A_log.shape[0]
        self.in_proj.normal_(0.0, d ** -0.5, generator=generator)
        self.conv_w.normal_(0.0, 0.1, generator=generator)
        self.out_proj.normal_(0.0, din ** -0.5, generator=generator)
        self.conv_b.zero_()
        self.dt_bias.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
        self.D.fill_(1.0)
        self.norm.fill_(1.0)


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * g * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :din]
    bmat = xbc[..., din:din + g * n]
    cmat = xbc[..., din + g * n:]
    return x, bmat, cmat


def _conv_silu(padded: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               s: int, dtype) -> torch.Tensor:
    """silu(sum_i padded[:, i:i+s] * w[i] + b) in float32, the taps
    accumulated from zero in order (the order of both the prefill and the
    decode step), cast to ``dtype``.  padded: (B, s + K - 1, Cd)."""
    f32 = torch.float32
    pf, wf = padded.to(f32), w.to(f32)
    out = pf[:, :s] * wf[0]       # 0 + the first tap, exactly
    for i in range(1, wf.shape[0]):   # K is 4: an unrolled shift-and-add
        out = out + pf[:, i:i + s] * wf[i]
    return F.silu(out + b.to(f32)).to(dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d and SiLU.  xbc: (B, S, Cd), w: (K, Cd),
    tail: (B, K-1, Cd) (zeros when None); float32 inside, returned in
    xbc's dtype."""
    k = w.shape[0]
    f32 = torch.float32
    if tail is None:
        tail = torch.zeros(xbc.shape[0], k - 1, xbc.shape[2], dtype=f32,
                           device=xbc.device)
    padded = torch.cat([tail.to(f32), xbc.to(f32)], dim=1)
    return _conv_silu(padded, w, b, xbc.shape[1], xbc.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, cfg: ModelConfig,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P), dt: (B, S, H) (post-softplus), a: (H,) negative,
    bmat/cmat: (B, S, G, N), S a multiple of the chunk.  Returns (y (B,
    S, H, P) float32, final state (B, H, P, N) float32).  Heads are
    group-major: head j belongs to group j // (H / G).

    Without a gradient to take, the score-sized and state-sized buffers
    are updated in place; when grad mode is on and an input requires grad
    the same values are computed out of place (autograd rejects a backward
    through those updates, and a checkpointed layer's recompute would not
    notice them).
    """
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, dt, a, bmat, cmat, init_state))
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    l = min(cfg.ssm_chunk, s)
    if s % l:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {l}")
    nc = s // l

    f32 = torch.float32
    xc = x.reshape(b, nc, l, g, hg, p).to(f32)
    dtc = dt.reshape(b, nc, l, g, hg).to(f32)
    bc = bmat.reshape(b, nc, l, g, n).to(f32)
    cc = cmat.reshape(b, nc, l, g, n).to(f32)
    da = dtc * a.to(f32).reshape(g, hg)               # (B,NC,L,G,Hg)
    cums = torch.cumsum(da, dim=2)                    # within each chunk
    del da

    # ---- intra-chunk (quadratic) term ----
    # att[b,c,l,g,h,m] = (C_l . B_m) * exp(cums_l - cums_m) * dt_m, l >= m;
    # the exponent is masked (not the product): exp of the positive upper
    # triangle would overflow to inf, and inf * 0 is NaN
    cb = torch.einsum("bclgn,bcmgn->bcglm", cc, bc)
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    att = cums[..., None] - cums.permute(0, 1, 3, 4, 2)[:, :, None]
    hidden = ~mask[None, None, :, None, None, :]
    cb = cb.permute(0, 1, 3, 2, 4)[:, :, :, :, None, :]
    dtm = dtc.permute(0, 1, 3, 4, 2)[:, :, None]
    if grad:
        att = torch.exp(att.masked_fill(hidden, -math.inf)) * cb * dtm
    else:
        att.masked_fill_(hidden, -math.inf)
        att.exp_()
        att.mul_(cb)
        att.mul_(dtm)
    del cb
    y = torch.einsum("bclghm,bcmghp->bclghp", att, xc)
    del att

    # ---- chunk state summaries: scale x, then contract over l ----
    w_end = torch.exp(cums[:, :, -1:] - cums) * dtc   # (B,NC,L,G,Hg)
    states = torch.einsum("bclghp,bclgn->bcghpn", xc * w_end[..., None], bc)
    del w_end

    # ---- inter-chunk recurrence: states[:, c] becomes the state that
    # enters chunk c ----
    chunk_decay = torch.exp(cums[:, :, -1])           # (B,NC,G,Hg)
    carry = (torch.zeros(b, g, hg, p, n, dtype=f32, device=x.device)
             if init_state is None
             else init_state.reshape(b, g, hg, p, n).to(f32))
    ins = []
    for c in range(nc):
        nxt = carry * chunk_decay[:, c, :, :, None, None] + states[:, c]
        if grad:
            ins.append(carry)
        else:
            states[:, c] = carry
        carry = nxt
    if grad:
        states = torch.stack(ins, dim=1)

    # ---- off-diagonal contribution of the incoming state: contract C
    # with it over n, then scale by exp(cums) ----
    y_off = torch.einsum("bclgn,bcghpn->bclghp", cc, states)
    del states
    if grad:
        y = y + y_off * torch.exp(cums)[..., None]
    else:
        y_off.mul_(torch.exp(cums)[..., None])
        y.add_(y_off)
    return y.reshape(b, s, h, p), carry.reshape(b, h, p, n)


def mamba_forward(m: Mamba, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[SSMState] = None,
                  return_state: bool = False
                  ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full-sequence Mamba2 block.  x: (B, S, D); ``state`` continues a
    sequence (its conv tail and SSM state); with ``return_state`` also the
    state after the last token (the conv tail needs S >= K - 1)."""
    zxbcdt = x @ m.in_proj.to(x.dtype)
    z, xbc_raw, dtr = _split_proj(zxbcdt, cfg)
    tail = state.conv if state is not None else None
    xbc = _causal_conv(xbc_raw, m.conv_w, m.conv_b, tail)
    xs, bmat, cmat = _split_xbc(xbc, cfg)

    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    bsz, s, _ = x.shape
    f32 = torch.float32
    dt = torch.clamp(F.softplus(dtr.to(f32) + m.dt_bias.to(f32)),
                     0.0, DT_LIMIT)
    a = -torch.exp(m.A_log.to(f32))
    xh = xs.reshape(bsz, s, h, p)
    # pad S to a chunk multiple; padded steps get dt = 0 (identity state
    # transition, zero input), so outputs and the final state are exact
    pad = (-s) % min(cfg.ssm_chunk, max(s, 1))
    xp, bp, cp = xh, bmat, cmat
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bp = F.pad(bmat, (0, 0, 0, pad))
        cp = F.pad(cmat, (0, 0, 0, pad))
    y, final = ssd_chunked(xp, dt, a, bp.reshape(bsz, s + pad, g, n),
                           cp.reshape(bsz, s + pad, g, n), cfg,
                           init_state=state.state if state is not None
                           else None)
    if pad:
        y = y[:, :s]
    # the D-residual in float32, as mamba_step adds it before its cast
    y = (y + xh.to(f32) * m.D.to(f32)[None, None, :, None]).to(x.dtype)
    y = y.reshape(bsz, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), m.norm, cfg.norm_eps)
    out = y @ m.out_proj.to(x.dtype)
    new_state = None
    if return_state:
        k = cfg.ssm_conv
        new_state = SSMState(state=final, conv=xbc_raw[:, -(k - 1):, :])
    return out, new_state


def ssd_step(st: torch.Tensor, xh: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence, in float32: st (B, H, P, N), xh (B, H,
    P), dt (B, H) (post-softplus), a (H,) negative, bmat/cmat (B, G, N)
    (each group's B and C repeated over its H / G heads), d (H,).
    Returns (y = C h + D x (B, H, P), the new state)."""
    f32 = torch.float32
    hg = xh.shape[1] // bmat.shape[1]
    xh = xh.to(f32)
    bm_h = torch.repeat_interleave(bmat.to(f32), hg, dim=1)   # (B,H,N)
    cm_h = torch.repeat_interleave(cmat.to(f32), hg, dim=1)
    da = torch.exp(dt * a)
    st = st.to(f32) * da[..., None, None] + \
        (dt[..., None] * xh)[..., None] * bm_h[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", st, cm_h)
    return y + xh * d.to(f32)[None, :, None], st


def mamba_step(m: Mamba, x: torch.Tensor, cfg: ModelConfig,
               state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Single-token decode.  x: (B, 1, D) -> (y (B, 1, D), new state)."""
    zxbcdt = x @ m.in_proj.to(x.dtype)
    z, xbc_raw, dtr = _split_proj(zxbcdt, cfg)
    conv = torch.cat([state.conv.to(x.dtype), xbc_raw], dim=1)   # (B,K,Cd)
    f32 = torch.float32
    xbc = _conv_silu(conv, m.conv_w, m.conv_b, 1, x.dtype)
    xs, bmat, cmat = _split_xbc(xbc, cfg)

    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    bsz = x.shape[0]
    dt = torch.clamp(F.softplus(dtr[:, 0].to(f32) + m.dt_bias.to(f32)),
                     0.0, DT_LIMIT)                            # (B,H)
    y, st = ssd_step(state.state, xs[:, 0].reshape(bsz, h, p), dt,
                     -torch.exp(m.A_log.to(f32)),
                     bmat[:, 0].reshape(bsz, g, n),
                     cmat[:, 0].reshape(bsz, g, n), m.D)
    y = y.reshape(bsz, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), m.norm, cfg.norm_eps)
    out = y @ m.out_proj.to(x.dtype)
    return out, SSMState(state=st, conv=conv[:, 1:, :])
