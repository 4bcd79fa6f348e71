"""Faults planted in the system under test, each a function that breaks the
Port it is given before anything is captured: the check has to read every
one as not correct.  The CPU tests plant them at tiny scenes, and

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --fault <name>

reads them on the card at the cell's own size.
"""
from __future__ import annotations

import dataclasses


def unchanged(port):
    """A step that returns its state unchanged."""
    port.step = lambda state: state


def half_left_out(port):
    """Every other row's new messages left out (zero)."""
    step = port.step

    def broken(state):
        new = step(state)
        for t in (*new.f.msg_eta, *new.f.msg_lam):
            t[:, 1::2] = 0.0
        return new
    port.step = broken


def answer_altered(port):
    """One landmark's mean moved where the step produces it."""
    step = port.step

    def broken(state):
        new = step(state)
        new.v[1].mean[0] += 0.5
        return new
    port.step = broken


def are_altered(port):
    """The ARE a solve stops on, halved (only the solve loop reads it)."""
    are = port.are
    port.are = lambda state: 0.5 * are(state)


def never_relinearizes(port):
    """A relinearization threshold no row ever passes."""
    port.cfg = dataclasses.replace(port.cfg, beta=float("inf"))


FAULTS = {f.__name__: f for f in (unchanged, half_left_out, answer_altered, are_altered,
                                  never_relinearizes)}
