"""The train-mode model against the JAX package: ``lm_loss`` and its
gradients, remat, the parameter counts, the specs of ``model_zoo``, and
the refusal of a gradient through a kernel.

* ``lm_loss`` and its gradients against ``jax.grad`` for one smoke config
  per family (nemotron, chatglm3, mixtral, mamba2, jamba, whisper-base,
  llama-3.2-vision), the same weights (the port's, carried to a JAX tree)
  and numpy inputs with masked labels: float32 within 1e-4 x max|g|, and
  chatglm3 in bf16 within 2e-2;
* ``dual`` without the kernel gives the dense gradients, as in JAX;
* ``remat`` none, full and dots give equal gradients;
* the KV-chunked attention's gradients (chunks of 4, remat full and
  dots) equal JAX's single-block ones;
* ``count_params`` and ``active_params``, ``input_specs`` and
  ``cache_specs`` equal to the JAX package's (shapes and dtypes);
* a gradient through a kernel raises ``NotImplementedError`` in both
  packages (``sparse_use_kernel=True``), through K1-K7's wrappers;
* ``_attend_block``'s in-place and out-of-place forms give equal values;
* ``model_zoo.build_model`` defaults to the card.

The JAX side runs ``jax.jit(jax.value_and_grad(lm_loss))`` once per
config, with ``remat="none"`` and ``scan_unroll=True`` (the gradient
depends on neither, the compile is shorter); the gradient cases cut each
smoke config to one period.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtfm
import repro_torch.configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.kernels import bitmap_encode as k5
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.kernels import grouped_spgemm as gsk
from repro_torch.kernels import sparse_im2col as k67
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.sparse import site
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl

torch.set_num_threads(1)

FAMILIES = ("nemotron-4-340b", "chatglm3-6b", "mixtral-8x7b", "mamba2-370m",
            "jamba-1.5-large-398b", "whisper-base", "llama-3.2-vision-90b")
ALL = FAMILIES + ("qwen1.5-110b", "yi-34b", "qwen3-moe-235b-a22b")
B, S = 2, 12


def _cfgs(arch):
    """The port's and the JAX package's smoke config, cut to one period
    (the hybrid's 8 layers, the VLM's 5): every layer kind, half the
    JAX compile."""
    tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
    return (dataclasses.replace(tcfg, n_layers=tcfg.period),
            dataclasses.replace(jcfg, n_layers=jcfg.period))


def _model(arch):
    """The smoke model (one period) from a seed, its qkv biases and VLM
    gates drawn non-zero (both start at zero) so their gradients are not
    trivial."""
    cfg = _cfgs(arch)[0]
    model = ttfm.init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(("attn.bq", "attn.bk", "attn.bv", "gate_attn")):
                p.copy_(0.5 * torch.randn(p.shape, generator=g))
    return cfg, model


def _jax_tree(model, cfg):
    """The JAX ``init_model`` tree of the port's weights: each layer's
    tensor at its index of its period position's stacked leaf."""
    tree, stacks = {}, {}
    for n, p in model.named_parameters():
        key, j = topt.stacked_leaf(n, cfg.period)
        a = p.detach().numpy().copy()
        if j is not None:
            stacks.setdefault(key, {})[j] = a
            continue
        node = tree
        *head, last = key.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = a
    for key, by_j in stacks.items():
        node = tree
        *head, last = key.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = np.stack([by_j[j] for j in range(len(by_j))])
    return tree


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][0, :3] = -1                    # masked positions
    if cfg.frontend == "audio":
        out["mel"] = np.maximum(rng.normal(
            size=(B, 2 * cfg.encoder_len, cfg.n_mels)), 0).astype(np.float32)
    if cfg.frontend == "vision":
        out["images"] = np.maximum(rng.normal(
            size=(B, cfg.image_size, cfg.image_size, cfg.image_channels)),
            0).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch, act="float32"):
    cfg, model = _model(arch)
    jcfg = _cfgs(arch)[1]
    rc = JRunConfig(act_dtype=act, remat="none", scan_unroll=True)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.lm_loss(p, b, jcfg, rc=rc), has_aux=True))
    (total, metrics), g = f(_jax_tree(model, cfg), _batch(cfg))
    return (float(total), {k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, g))


def _port_grads(model, cfg, rc, batch):
    model.requires_grad_(True)
    total, metrics = ttfm.lm_loss(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, rc=rc)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in
                                        model.named_parameters()])
    return total.item(), metrics, dict(zip(names, grads))


def _leaf(tree, name, period):
    key, j = topt.stacked_leaf(name, period)
    for part in key.split("."):
        tree = tree[part]
    return tree if j is None else tree[j]


def _check_grads(grads, jg, period, rtol):
    gmax = max(np.abs(_leaf(jg, n, period)).max() for n in grads)
    for n, g in grads.items():
        want = _leaf(jg, n, period)
        assert tuple(g.shape) == want.shape, n
        np.testing.assert_allclose(g.to(torch.float32).numpy(), want,
                                   rtol=0, atol=rtol * gmax, err_msg=n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_grads_match_jax(arch):
    cfg, model = _model(arch)
    total, metrics, jg = _jax_loss_grads(arch)
    got, tm, grads = _port_grads(model, cfg, TRunConfig(act_dtype="float32"),
                                 _batch(cfg))
    assert got == pytest.approx(total, rel=1e-5)
    for k in ("loss", "aux_loss", "tokens"):
        assert tm[k].item() == pytest.approx(metrics[k], rel=1e-5, abs=1e-6)
    assert tm["tokens"].item() == B * S - 3
    _check_grads(grads, jg, cfg.period, 1e-4)


def test_lm_loss_grads_match_jax_bf16():
    arch = "chatglm3-6b"
    cfg, model = _model(arch)
    total, _, jg = _jax_loss_grads(arch, "bfloat16")
    got, _, grads = _port_grads(model, cfg, TRunConfig(), _batch(cfg))
    assert got == pytest.approx(total, rel=2e-2)
    _check_grads(grads, jg, cfg.period, 2e-2)


def test_dual_without_kernel_gives_dense_grads():
    """As in the JAX package: the sparse dispatch without the kernel is
    the dense product, so its gradients are the dense ones."""
    arch = "nemotron-4-340b"
    cfg, model = _model(arch)
    _, _, jg = _jax_loss_grads(arch)
    rc = TRunConfig(act_dtype="float32")
    for knobs in (dict(sparse_mode="dual"),
                  dict(sparse_mode="dual", sparse_kcondense=True)):
        c = dataclasses.replace(cfg, **knobs)
        _, _, grads = _port_grads(model, c, rc, _batch(cfg))
        _check_grads(grads, jg, cfg.period, 1e-4)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-370m"])
def test_remat_modes_give_equal_grads(arch, act):
    """Through the train step's gradient (bf16 compute copies under
    ``functional_call`` in bf16): each layer recomputes on the tensors it
    ran on."""
    cfg, model = _model(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    got = {}
    for remat in ("none", "full", "dots"):
        rc = TRunConfig(act_dtype=act, remat=remat, microbatches=2)
        got[remat] = ttl.make_grad_fn(cfg, rc)(model.requires_grad_(True),
                                               batch)
    for remat in ("full", "dots"):
        assert got[remat][1] == got["none"][1]
        for n, g in got["none"][0].items():
            torch.testing.assert_close(got[remat][0][n], g, rtol=0,
                                       atol=1e-7, msg=f"{remat} {n}")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_chunked_attention_grads_match_jax(remat, monkeypatch):
    """``attend``'s KV-chunked path (a running log-sum-exp over chunks of
    4 at S = 12) under a per-layer checkpoint: the gradients are the JAX
    package's single-block ones, within 1e-4 x max|g|."""
    arch = "chatglm3-6b"
    cfg, model = _model(arch)
    total, _, jg = _jax_loss_grads(arch)
    widths = []
    block = tattn._attend_block

    def spy(q, k, *args):
        widths.append(k.shape[1])
        return block(q, k, *args)
    monkeypatch.setattr(tattn, "_attend_block", spy)
    rc = TRunConfig(act_dtype="float32", remat=remat, attn_chunk=4)
    got, _, grads = _port_grads(model, cfg, rc, _batch(cfg))
    assert widths and set(widths) == {4}
    assert got == pytest.approx(total, rel=1e-5)
    _check_grads(grads, jg, cfg.period, 1e-4)


def test_remat_context_rejects_unknown():
    with pytest.raises(ValueError):
        ttfm.remat_context("some")


@pytest.mark.parametrize("arch", ALL)
def test_param_counts_match_jax(arch):
    for name in (arch, f"{arch}-smoke"):
        tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
        tmodel, _ = tzoo.abstract_params(tcfg)
        assert {p.device.type for p in tmodel.parameters()} == {"meta"}
        shapes, _ = jzoo.abstract_params(jcfg)
        assert ttfm.count_params(tmodel) == jtfm.count_params(shapes)
        assert ttfm.active_params(tcfg, tmodel) == pytest.approx(
            jtfm.active_params(jcfg, shapes), rel=1e-12)


def _specs_equal(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-base",
                                  "llama-3.2-vision-90b",
                                  "jamba-1.5-large-398b"])
def test_input_and_cache_specs_match_jax(arch):
    tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
    for shape in tconfigs.SHAPES[:3]:
        jshape = jconfigs.SHAPES_BY_NAME[shape.name]
        got, want = tzoo.input_specs(tcfg, shape), jzoo.input_specs(jcfg,
                                                                  jshape)
        assert set(got) == set(want), shape.name
        for k in got:
            assert got[k].device.type == "meta"
            _specs_equal(got[k], want[k])
    shape = dataclasses.replace(tconfigs.SHAPES_BY_NAME["decode_32k"],
                                global_batch=2, seq_len=64)
    jshape = jconfigs.ShapeConfig(*dataclasses.astuple(shape))
    for quantized in (False, True):
        got = tzoo.cache_specs(tcfg, shape, quantized=quantized)
        want = jzoo.cache_specs(jcfg, jshape, quantized=quantized)
        assert len(got) == tcfg.n_layers
        for i, c in enumerate(got):
            w = want[f"pos{i % tcfg.period}"]
            pairs = ([("kv", c.kv), ("cross_kv", c.cross_kv)]
                     if isinstance(c, tuple) and hasattr(c, "cross_kv")
                     else [("ssm", c)] if isinstance(c, tssm.SSMState)
                     else [("kv", c)])
            for key, cc in pairs:
                fields = (("state", "conv") if key == "ssm" else
                          ("k", "v") + (("k_scale", "v_scale")
                                        if cc.k_scale is not None else ()))
                for f in fields:
                    ref = getattr(w[key], f)
                    ref = jax.ShapeDtypeStruct(ref.shape[1:], ref.dtype)
                    _specs_equal(getattr(cc, f), ref)


def test_frontend_inputs():
    cfg = tconfigs.smoke_config("whisper-base")
    a = tzoo.frontend_inputs(cfg, 2, seed=1, device="cpu")
    b = tzoo.frontend_inputs(cfg, 2, seed=1, device="cpu")
    jx = jzoo.frontend_inputs(jconfigs.smoke_config("whisper-base"), 2)
    assert set(a) == set(jx) == {"mel"}
    _specs_equal(a["mel"], jx["mel"])
    assert torch.equal(a["mel"], b["mel"])
    assert (a["mel"] >= 0).all() and (a["mel"] == 0).any()
    assert tzoo.frontend_inputs(tconfigs.smoke_config("chatglm3-6b"), 2,
                                device="cpu") == {}
    v = tzoo.frontend_inputs(tconfigs.smoke_config("llama-3.2-vision-90b"),
                             2, device="cpu")
    cfg = tconfigs.smoke_config("llama-3.2-vision-90b")
    assert tuple(v["images"].shape) == (2, cfg.image_size, cfg.image_size,
                                        cfg.image_channels)


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs on it")
    cfg = tconfigs.smoke_config("chatglm3-6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.frontend_inputs(tconfigs.smoke_config("whisper-base"), 1)
    a = tzoo.build_model(cfg, 0, device="cpu")
    b = tzoo.build_model(cfg, 0, device="cpu")
    assert a.embed.dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


# ---------------------------------------------------------------------------
# the gradient guard
# ---------------------------------------------------------------------------

def test_gradient_through_a_kernel_raises_in_both_packages():
    arch = "nemotron-4-340b"
    knobs = dict(sparse_mode="dual", sparse_use_kernel=True)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **knobs)
    cfg, model = _model(arch)
    c = dataclasses.replace(cfg, **knobs)
    batch = _batch(cfg)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda p: jtfm.lm_loss(p, batch, jcfg)[0])(
            _jax_tree(model, cfg))
    step = ttl.make_train_step(c, TRunConfig(act_dtype="float32"))
    ostate = topt.init_opt_state(dict(model.named_parameters()),
                                 TRunConfig())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        step(model, ostate, None, tb)
    # the refusal degrades no site; serving takes no gradient
    assert site.quarantine_report() == {}
    with torch.no_grad():
        out = model(tb, c)
    assert torch.isfinite(out.logits).all()


def test_every_kernel_wrapper_refuses_a_gradient():
    a = torch.rand(8, 16, requires_grad=True)
    b = torch.rand(16, 8)
    ks = torch.zeros(1, 1, 1, dtype=torch.int32)
    counts = torch.ones(1, 1, dtype=torch.int32)
    geom = dict(block_m=8, block_n=8, slice_k=16, device="cpu")
    gk = torch.arange(16, dtype=torch.int32).reshape(1, 1, 1, 16)
    x = torch.rand(1, 2, 4, 8, requires_grad=True)
    bits, cond = k5.bitmap_encode(x.detach(), device="cpu")
    calls = {
        "K1": lambda a: bsk.bitmap_spgemm_planned(a, b, ks, counts, **geom),
        "K2": lambda a: bsk.bitmap_spgemm_kfused_planned(a, b, gk, counts,
                                                         **geom),
        "K3": lambda a: gsk.grouped_spgemm_planned(a[None], b[None],
                                                   ks[None], counts[None],
                                                   **geom),
        "K4": lambda a: gsk.grouped_spgemm_kfused_planned(
            a[None], b[None], gk[None], counts[None], **geom),
        "K5": lambda _: k5.bitmap_encode(x, device="cpu"),
        "K6": lambda _: k67.sparse_im2col(cond.requires_grad_(), bits,
                                          kh=1, kw=3, device="cpu"),
        "K7": lambda _: k67.sparse_im2col_strided(
            cond.requires_grad_(), bits, kh=1, kw=3, stride=2,
            device="cpu"),
    }
    for kn, call in calls.items():
        with pytest.raises(NotImplementedError, match="no backward"):
            call(a)
        with torch.no_grad():
            call(a)                              # serving is unaffected


@pytest.mark.parametrize("window", [None, 3])
def test_attend_block_forms_equal(window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 2, 3, 8, generator=g)
    k = torch.randn(2, 7, 2, 8, generator=g)
    v = torch.randn(2, 7, 2, 8, generator=g)
    qpos, kpos = torch.arange(2, 7), torch.arange(7)
    kpos[-1] = -1                                  # an invalid slot
    with torch.no_grad():
        want = tattn._attend_block(q, k, v, qpos, kpos, window)
    qg = q.clone().requires_grad_()
    got = tattn._attend_block(qg, k, v, qpos, kpos, window)
    for x, y in zip(got, want):
        assert x.requires_grad or x.grad_fn is None
        assert torch.equal(x.detach(), y)
    got[0].sum().backward()
    assert torch.isfinite(qg.grad).all()
