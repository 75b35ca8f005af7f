"""The port's static analysis (``python -m igneous_tpu_torch lint``).

The port's copy of ``igneous_tpu/analysis``: five AST passes over the
port's own sources — knob registry (IGN1xx), recompile hazards (IGN2xx),
lock discipline (IGN3xx), determinism (IGN4xx), telemetry grammar
(IGN5xx) — plus the :mod:`.knobs` registry every module of the port reads
its ``IGNEOUS_*`` configuration through, and the :mod:`.racecheck`
dynamic lock checker.

Standard library only (``ast``, ``re``, ``json``).
"""

from . import knobs  # noqa: F401  (the runtime-facing registry)
from .findings import Finding  # noqa: F401
from .runner import main, run_passes  # noqa: F401
