"""The conv frontends of the audio and vision towers.

* **audio** — whisper's two-conv mel stem: conv k=3 stride 1 over time
  (n_mels → d_model), GeLU, conv k=3 stride 2 (d_model → d_model), GeLU,
  with SAME time padding, so ``(B, 2·encoder_len, n_mels)`` mel frames
  become ``(B, encoder_len, d_model)`` encoder inputs.  Both are 2-D
  convs with a singleton height, on the tape as ``conv.stem1`` and
  ``conv.stem2``.
* **vision** — a patch-conv tower: a VALID conv with kernel = stride =
  ``patch_size`` (image_channels → d_model), flattened to the patch grid,
  plus the bias, a learned cls token in front (when ``num_image_tokens``
  is the grid + 1) and learned positions, on the tape as ``conv.patch``.

Every conv rides :func:`repro_torch.sparse.site.conv2d`: ``F.conv2d`` in
dense mode, the bitmap implicit im2col (K5 → K6 at stride 1, K5 → K7 at
stride ≥ 2) feeding K1/K2 otherwise.  The JAX package's
``models/frontend.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sparse import activation as act
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site
from repro_torch.sparse import weights as spw
from repro_torch.sparse.conv import PlannedConv
from repro_torch.sparse.weights import PlannedWeight

_SITE_NAMES = {"conv1": "conv.stem1", "conv2": "conv.stem2",
               "patch": "conv.patch"}


def _zeros(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


class AudioFrontend(nn.Module):
    """conv1 (1, 3, n_mels, d), b1 (d), conv2 (1, 3, d, d), b2 (d): the JAX
    layouts, (KH, KW, C, F)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, kw = cfg.d_model, dict(device=device, dtype=dtype)
        self.conv1 = _zeros(1, 3, cfg.n_mels, d, **kw)
        self.b1 = _zeros(d, **kw)
        self.conv2 = _zeros(1, 3, d, d, **kw)
        self.b2 = _zeros(d, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: normal(0, 0.02) kernels, zero biases."""
        for w in (self.conv1, self.conv2):
            w.normal_(0.0, 0.02, generator=generator)


class VisionFrontend(nn.Module):
    """patch (ps, ps, C, d), bias (d), pos (num_image_tokens, d) and, when
    the token count is the patch grid + 1, cls (d): the JAX layouts."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, ps = cfg.d_model, cfg.patch_size
        g, kw = cfg.image_size // ps, dict(device=device, dtype=dtype)
        self.patch = _zeros(ps, ps, cfg.image_channels, d, **kw)
        self.bias = _zeros(d, **kw)
        self.pos = _zeros(cfg.num_image_tokens, d, **kw)
        self.cls = (_zeros(d, **kw) if cfg.num_image_tokens == g * g + 1
                    else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: normal(0, 0.02) patch kernel, positions
        and cls token, a zero bias."""
        for w in (self.patch, self.pos, self.cls):
            if w is not None:
                w.normal_(0.0, 0.02, generator=generator)


def conv_site(key: str) -> site.OpSite:
    """The declarative site of stem conv ``key``."""
    return site.make("conv", _SITE_NAMES[key], axes=("conv_fiber", "embed"))


def _planned_conv(w4: torch.Tensor, plans: Optional[Dict], key: str, dtype,
                  cfg: ModelConfig):
    """A conv kernel with its cached ``(KH·KW·C, F)`` activity attached as
    a :class:`PlannedConv`, or the bare 4-D tensor without a plan."""
    kh, kw, c, f = w4.shape
    ebn = cfg.sparse_block_n if cfg.sparse_kcondense else 0
    w2 = spw.planned_or_array(w4.reshape(kh * kw * c, f), plans, key, dtype,
                              cfg.sparse_slice_k, block_n=ebn,
                              site=conv_site(key))
    if isinstance(w2, PlannedWeight):
        return PlannedConv(weight=w2, kh=kh, kw=kw, site=conv_site(key))
    return w4.to(dtype)


def audio_frontend(fp: AudioFrontend, mel: torch.Tensor, cfg: ModelConfig,
                   *, plans: Optional[Dict] = None) -> torch.Tensor:
    """mel (B, T, n_mels) → (B, T//2, d_model)."""
    x = F.pad(mel[:, None], (0, 0, 1, 1))               # (B, 1, T+2, M)
    w1 = _planned_conv(fp.conv1, plans, "conv1", x.dtype, cfg)
    y, _ = site.conv2d(x, w1, 1, site=conv_site("conv1"), cfg=cfg)
    y = act.gelu(y + fp.b1.to(y.dtype))
    y = F.pad(y, (0, 0, 1, 1))
    w2 = _planned_conv(fp.conv2, plans, "conv2", y.dtype, cfg)
    y, _ = site.conv2d(y, w2, 2, site=conv_site("conv2"), cfg=cfg)
    y = act.gelu(y + fp.b2.to(y.dtype))
    return y[:, 0]                                      # (B, T//2, D)


def vision_frontend(fp: VisionFrontend, images: torch.Tensor,
                    cfg: ModelConfig, *, plans: Optional[Dict] = None
                    ) -> torch.Tensor:
    """images (B, H, W, C) → (B, num_image_tokens, d_model): the patch
    conv, then the bias, the cls token in front and the positions, each
    in the images' dtype, in the JAX package's order."""
    w = _planned_conv(fp.patch, plans, "patch", images.dtype, cfg)
    y, _ = site.conv2d(images, w, cfg.patch_size, site=conv_site("patch"),
                       cfg=cfg)
    b, g1, g2, d = y.shape
    y = y.reshape(b, g1 * g2, d) + fp.bias.to(y.dtype)
    if fp.cls is not None:
        y = torch.cat([fp.cls.to(y.dtype).expand(b, 1, d), y], dim=1)
    return y + fp.pos.to(y.dtype)[None]


Frontend = Union[AudioFrontend, VisionFrontend]


def init_frontend(cfg: ModelConfig, *, device=None, dtype=None) -> Frontend:
    """The conv frontend of ``cfg.frontend``."""
    if cfg.frontend == "audio":
        return AudioFrontend(cfg, device=device, dtype=dtype)
    if cfg.frontend == "vision":
        return VisionFrontend(cfg, device=device, dtype=dtype)
    raise ValueError(f"no conv frontend for frontend={cfg.frontend!r}")


def frontend_forward(fp: Frontend, batch: Dict, cfg: ModelConfig, dtype, *,
                     plans: Optional[Dict] = None) -> torch.Tensor:
    """Dispatch on modality: the raw batch input (``"mel"`` or
    ``"images"``) → memory embeddings."""
    if cfg.frontend == "audio":
        return audio_frontend(fp, batch["mel"].to(dtype), cfg, plans=plans)
    return vision_frontend(fp, batch["images"].to(dtype), cfg, plans=plans)


def plan_frontend_activities(fp: Frontend, cfg: ModelConfig) -> Dict:
    """The stem convs' weight-side plans: ``(KH·KW·C, F)`` slice
    activities, with ``"@elem"`` element activities under kcondense."""
    out: Dict[str, torch.Tensor] = {}
    for key in _SITE_NAMES:
        w4 = getattr(fp, key, None)
        if w4 is None:
            continue
        w2 = w4.reshape(-1, w4.shape[-1])
        out[key] = pln.slice_activity_rhs(
            w2, pln.effective_slice_k(w2.shape[0], cfg.sparse_slice_k))
        if cfg.sparse_kcondense:
            out[f"{key}@elem"] = pln.element_activity_rhs(
                w2, cfg.sparse_block_n)
    return out
