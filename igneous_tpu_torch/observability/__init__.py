"""Observability of the port: the device ledger (``observability.device``).
The stage timers and counters are ``igneous_tpu_torch.telemetry``."""
