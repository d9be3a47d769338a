"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points default to the card instead of falling back to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib', 'repro.')) or n == 'repro')\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every submodule imported
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if FORBIDDEN.search(p.read_text())]
    assert not offenders, offenders


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs on it")
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop

    cfg = smoke_config("nemotron-4-340b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_model(cfg)
    model = tfm.init_model(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_loop.generate(model, {"tokens": torch.zeros(1, 3,
                                                          dtype=torch.long)},
                            cfg, max_new_tokens=2)
    z = torch.zeros(8, 8)
    zi = torch.zeros(1, 1, 1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bsk.bitmap_spgemm_planned(z, z, zi, zi[0], block_m=8, block_n=8,
                                  slice_k=8)
    # asking for the CPU explicitly runs there
    out = serve_loop.generate(model, {"tokens": torch.zeros(1, 3,
                                                            dtype=torch.long)},
                              cfg, max_new_tokens=2, device="cpu")
    assert tuple(out.shape) == (1, 2)


def test_every_module_imports_first():
    """Each module of the port imports in a process where no other module
    of the port is loaded yet (a circular import shows only in some
    orders)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40
