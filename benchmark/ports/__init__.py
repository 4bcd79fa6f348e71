"""Systems under test by name: `ports/<name>.py` exposes `Port(sim, config,
device)`; a configuration names its port ("port").  A new path through the
program is a new file here.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.ports.{name}").Port
