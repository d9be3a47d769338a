"""Checkpoints and restarts on the port: the JAX package's
``test_checkpoint.py`` (but its elastic restore, which waits for the
port's sharding) and ``test_system.py``'s crash-restart and
train-then-serve, then the launcher resumed on the CPU.

A bf16 leaf is stored as its uint16 bits with a ``bfloat16`` tag and read
back with ``Tensor.view``: the port's checkpoint never imports
``ml_dtypes``, which the card's host lacks.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as launcher
from repro_torch.models import model_zoo
from repro_torch.serving import serve_loop
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.fault_tolerance import (CheckpointManager,
                                                  StragglerMonitor,
                                                  run_with_restarts)
from repro_torch.training.train_loop import (load_state, make_train_step,
                                             state_tree)

torch.set_num_threads(1)


def _tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.from_numpy(rng.normal(size=(4,))).to(
                           torch.bfloat16)}}


def _leaves(tree):
    return [v for _, v in ckpt._flatten(tree)]


def test_roundtrip(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "step_1")
    ckpt.save(path, tree, step=1, extra={"note": "x"})
    restored, manifest = ckpt.load(path, tree, device="cpu")
    assert manifest["step"] == 1 and manifest["extra"]["note"] == "x"
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_bf16_without_ml_dtypes(tmp_path, rng, monkeypatch):
    tree = _tree(rng)
    path = str(tmp_path / "c")
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # import fails
    ckpt.save(path, tree, step=0)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["nested.c"] == "bfloat16"
    with np.load(os.path.join(path, "arrays-00000.npz")) as z:
        assert z["a2"].dtype == np.uint16
    restored, _ = ckpt.load(path, tree, device="cpu")
    assert restored["nested"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["c"], tree["nested"]["c"])


def test_shape_mismatch_rejected(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "c")
    ckpt.save(path, tree, step=0)
    bad = dict(tree)
    bad["a"] = torch.zeros(9, 16)
    with pytest.raises(ValueError):
        ckpt.load(path, bad, device="cpu")
    with pytest.raises(KeyError):
        ckpt.load(path, {**tree, "d": torch.zeros(1)}, device="cpu")


def test_atomic_no_tmp_left(tmp_path, rng):
    path = str(tmp_path / "c")
    ckpt.save(path, _tree(rng), step=0)
    assert not os.path.exists(path + ".tmp")
    assert os.path.exists(os.path.join(path, "manifest.json"))


def test_manager_retention_and_latest(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = _tree(rng)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": tree["a"] + s, "nested": tree["nested"]})
    assert mgr.steps() == [3, 4]
    restored, manifest = mgr.restore_latest(tree, device="cpu")
    assert manifest["step"] == 4
    torch.testing.assert_close(restored["a"], tree["a"] + 4)


def test_async_save_copies_before_returning(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = _tree(rng)
    want = tree["a"].clone()
    mgr.save(7, tree)
    tree["a"].add_(1.0)          # the next step's in-place update
    mgr.wait()
    assert mgr.steps() == [7]
    restored, _ = mgr.restore_latest(tree, device="cpu")
    assert torch.equal(restored["a"], want)


def test_deterministic_restart_stream():
    d1 = SyntheticTokens(64, 4, 8, seed=3)
    d2 = SyntheticTokens(64, 4, 8, seed=3)
    for s in (0, 5, 17):
        a, b = d1.batch_at(s), d2.batch_at(s)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_run_with_restarts():
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("node failure")
        return "done"

    seen = []
    assert run_with_restarts(flaky, max_restarts=3,
                             on_restart=seen.append) == "done"
    assert attempts["n"] == 3 and seen == [0, 1]
    with pytest.raises(RuntimeError):
        run_with_restarts(lambda: (_ for _ in ()).throw(
            RuntimeError("always")), max_restarts=1)


def test_straggler_monitor():
    t = {"now": 0.0}
    mon = StragglerMonitor(window=8, ratio=1.5, clock=lambda: t["now"])
    for _ in range(6):
        with mon:
            t["now"] += 0.01
    with mon:
        t["now"] += 0.08  # 8x the median: flagged
    assert mon.flags == 1
    with mon:
        t["now"] += 0.01  # back at the median: not flagged
    assert mon.flags == 1
    assert abs(mon.median - 0.01) < 1e-9


# ---------------------------------------------------------------------------
# train → checkpoint → crash → restart → serve (test_system.py's setup)
# ---------------------------------------------------------------------------

def _run_training(workdir, crash_at=None, total=8):
    """Train chatglm3-6b-smoke with a checkpoint after every step;
    optionally crash before step ``crash_at``."""
    cfg = smoke_config("chatglm3-6b")
    rc = RunConfig(microbatches=2, learning_rate=1e-3, warmup_steps=2)
    model = model_zoo.build_model(cfg, 0, device="cpu")
    ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
    step_fn = make_train_step(cfg, rc)
    data = SyntheticTokens(cfg.vocab_size, 8, 16, seed=0)
    mgr = CheckpointManager(workdir, keep=2, async_save=False)
    restored = mgr.restore_latest(state_tree(model, ostate), device="cpu")
    start = 0
    if restored is not None:
        st, manifest = restored
        ostate, start = load_state(model, st), manifest["step"]
    losses, ef = {}, None
    for i in range(start, total):
        if crash_at is not None and i == crash_at:
            raise RuntimeError("injected node failure")
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        model, ostate, ef, metrics = step_fn(model, ostate, ef, batch)
        losses[i] = metrics["loss"].item()
        mgr.save(i + 1, state_tree(model, ostate))
    mgr.wait()
    return model, losses


def test_train_crash_restart_bitwise(tmp_path):
    m_ref, losses_ref = _run_training(str(tmp_path / "ref"), total=6)
    with pytest.raises(RuntimeError, match="injected"):
        _run_training(str(tmp_path / "ft"), crash_at=3, total=6)
    m_ft, losses_ft = _run_training(str(tmp_path / "ft"), total=6)
    assert sorted(losses_ft) == [3, 4, 5]
    for s in (3, 4, 5):
        np.testing.assert_allclose(losses_ft[s], losses_ref[s], rtol=1e-5)
    for (n, a), b in zip(m_ref.named_parameters(), m_ft.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, err_msg=n)


def test_train_then_serve(tmp_path):
    model, losses = _run_training(str(tmp_path / "ts"), total=6)
    assert all(p.requires_grad for p in model.parameters())
    cfg = smoke_config("chatglm3-6b")
    out = serve_loop.generate(model, {"tokens": torch.tensor([[1, 2, 3, 4]])},
                              cfg, max_new_tokens=4, capacity=32,
                              device="cpu")
    assert out.shape == (1, 4)
    assert losses[max(losses)] < losses[min(losses)] + 1.0


def test_launcher_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "chatglm3-6b", "--smoke", "--steps", "12",
            "--ckpt-every", "6", "--global-batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    launcher.main(argv)
    out = capsys.readouterr().out
    assert "step    0  loss" in out and "step   10  loss" in out
    assert out.rstrip().endswith("training complete")
    assert sorted(os.listdir(tmp_path)) == ["step_00000006", "step_00000012"]
    launcher.main(argv)
    out = capsys.readouterr().out
    assert out.splitlines() == ["resumed from step 12", "training complete"]
    launcher.main(argv[:4] + ["18"] + argv[5:] + ["--compress-grads"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 12" and out[-1] == "training complete"
    assert sorted(os.listdir(tmp_path)) == ["step_00000012", "step_00000018"]


def test_entry_points_default_to_the_card(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs on it")
    tree = _tree(rng)
    path = str(tmp_path / "c")
    ckpt.save(path, tree, step=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.load(path, tree)
    mgr = CheckpointManager(str(tmp_path / "m"), async_save=False)
    mgr.save(1, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore_latest(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "chatglm3-6b", "--smoke", "--steps", "1",
                       "--ckpt-dir", str(tmp_path / "l")])
