"""Loop kinds by name: `loops/<kind>.py` exposes `run(cell) -> Outcome`;
a traffic mix (`traffic/<mix>.json`) names its kind ("loop") and gives its
parameters.  A new way of driving the port is a new file here.
"""
from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}").run
