"""Scenes by name: `generators/<name>.py` exposes `generate(**scene, seed)`
and `renoise(sim, seed, cam_noise, lmk_noise)`; a configuration names its
generator ("generator") and arguments ("scene").  A new generator is a new
file here.
"""
from __future__ import annotations

import importlib


def make_scene(config: dict, seed: int) -> dict:
    """The configuration's scene for a run's seed: its geometry (cameras,
    landmarks, which camera sees which landmark) from the configuration's
    fixed `geometry_seed`, so that every seed has the same sizes, and the
    noise of the observations and the initial estimate from `seed`."""
    gen = importlib.import_module(f"benchmark.generators.{config['generator']}")
    sim = gen.generate(**config["scene"], seed=config["geometry_seed"])
    noise = config["noise"]
    return gen.renoise(sim, seed, noise["cam"], noise["lmk"])
