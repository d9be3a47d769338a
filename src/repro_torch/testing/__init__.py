"""Test-support machinery shipped with the package.

``repro_torch.testing.faults`` is the deterministic fault-injection
harness; it lives inside ``src`` so that ``chip_smoke.py`` and the
serving engine's cooperative patch points import it without a test
runner on the path.
"""
from repro_torch.testing import faults  # noqa: F401
