"""The sparse dispatch layer: the planner (``plan``: schedules, the
card's ``knobs_valid``), activations, weight plans, the stats tape, the
dispatch (``dispatch``), conv, the KV caches, the call sites and their
resolution tiers and quarantine (``site``), the tuner and its cache
(``autotune``) and the invariant validators (``validate``).  Fault
injection lives in :mod:`repro_torch.testing.faults`."""
