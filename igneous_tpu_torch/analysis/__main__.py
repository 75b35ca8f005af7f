"""``python -m igneous_tpu_torch.analysis`` — the port's lint without the
CLI (the same options as ``python -m igneous_tpu_torch lint``)."""

from __future__ import annotations

import argparse
import sys

from .runner import add_arguments, run_args


def cli(argv=None) -> int:
  ap = argparse.ArgumentParser(
    prog="python -m igneous_tpu_torch lint",
    description="the port's static analysis (see README 'The port's "
                "static analysis')",
  )
  add_arguments(ap)
  return run_args(ap.parse_args(argv))


if __name__ == "__main__":
  sys.exit(cli())
