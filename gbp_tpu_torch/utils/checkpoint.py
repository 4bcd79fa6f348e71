"""Checkpoint / resume of GBP runs (counterpart of gbp_tpu/utils/checkpoint.py,
which writes a JAX checkpoint directory).

The whole algorithm state of a run is a tree of NamedTuples of tensors
(`core.sweep.GBPState`, `core.sweep_cm.CMState`, `parallel.halo.HaloState`,
`parallel.halo_cm.HaloCMState`): beliefs, messages, linearization points and
relinearization counters.  The graph (topology, measurements, priors) is
input data, rebuilt from the problem file; save it beside the state for a
self-contained resume (prior weakening changes the priors), and put the
schedule position (sweep index, weakenings applied) in `extras`, so that a
resume continues the annealing where it left off.

The format: one flat dict[str, Tensor] keyed by each tensor's path in the
tree ("state.v.0.eta", "graph.fblocks.0.z", "extras.sweep"), written with
`torch.save` and read back with `torch.load(weights_only=True)`: no class is
pickled.  Structure and everything that is not a tensor (factor types,
names, sizes) come from the templates on restore, as the reference takes
them from its templates.  Tensors are stored on the CPU and restored onto
each template tensor's device, so a checkpoint taken on the card resumes on
the CPU and back.
"""
from __future__ import annotations

import dataclasses
import os

import torch


def _leaves(obj, prefix: str, out: dict) -> dict:
    """Every tensor of the tree `obj` (NamedTuples, tuples, lists, dicts,
    dataclasses) into `out`, keyed by its path."""
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif isinstance(obj, (tuple, list)):
        names = obj._fields if hasattr(obj, "_fields") else range(len(obj))
        for name, item in zip(names, obj):
            _leaves(item, f"{prefix}.{name}", out)
    elif isinstance(obj, dict):
        for name, item in obj.items():
            _leaves(item, f"{prefix}.{name}", out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), f"{prefix}.{f.name}", out)
    return out


def _rebuild(tmpl, prefix: str, flat: dict, used: set):
    """`tmpl` with every tensor replaced by flat[path], checked against the
    template tensor's shape and dtype and moved to its device."""
    if isinstance(tmpl, torch.Tensor):
        if prefix not in flat:
            raise ValueError(f"checkpoint.restore: the checkpoint has no leaf {prefix!r}")
        got = flat[prefix]
        used.add(prefix)
        if got.shape != tmpl.shape or got.dtype != tmpl.dtype:
            raise ValueError(
                f"checkpoint.restore: leaf {prefix!r} is {got.dtype} {tuple(got.shape)} in the "
                f"checkpoint, the template wants {tmpl.dtype} {tuple(tmpl.shape)}")
        return got.to(tmpl.device)
    if isinstance(tmpl, (tuple, list)):
        names = tmpl._fields if hasattr(tmpl, "_fields") else range(len(tmpl))
        items = [_rebuild(item, f"{prefix}.{name}", flat, used) for name, item in zip(names, tmpl)]
        return type(tmpl)(*items) if hasattr(tmpl, "_fields") else type(tmpl)(items)
    if isinstance(tmpl, dict):
        return {name: _rebuild(item, f"{prefix}.{name}", flat, used)
                for name, item in tmpl.items()}
    if dataclasses.is_dataclass(tmpl) and not isinstance(tmpl, type):
        return dataclasses.replace(tmpl, **{
            f.name: _rebuild(getattr(tmpl, f.name), f"{prefix}.{f.name}", flat, used)
            for f in dataclasses.fields(tmpl) if f.init})
    return tmpl


def _extras(extras: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in extras.items()}


def save(path, state, graph=None, extras: dict | None = None) -> None:
    """Save a state tree, optionally the graph, and optionally an `extras`
    dict of scalars / tensors (e.g. {"sweep": i, "weakened": k}, the
    prior-weakening schedule's position) to the file `path`, replacing it."""
    item = {"state": state}
    if graph is not None:
        item["graph"] = graph
    if extras is not None:
        item["extras"] = _extras(extras)
    flat = {}
    for name, tree in item.items():
        _leaves(tree, name, flat)
    path = os.path.abspath(os.fspath(path))
    tmp = path + ".tmp"
    torch.save({k: t.detach().to("cpu", copy=True) for k, t in flat.items()}, tmp)
    os.replace(tmp, path)


def restore(path, state_template, graph_template=None, extras_template: dict | None = None):
    """Restore a checkpoint written by `save`.

    The templates give the tree structure, everything that is not a tensor,
    and each tensor's device; tensors are loaded from the file and must
    match the template's shape and dtype (an error names the leaf).
    Returns state, (state, graph), (state, extras) or (state, graph,
    extras), depending on which templates are given."""
    flat = torch.load(os.path.abspath(os.fspath(path)), map_location="cpu", weights_only=True)
    item = {"state": state_template}
    if graph_template is not None:
        item["graph"] = graph_template
    if extras_template is not None:
        item["extras"] = _extras(extras_template)
    used = set()
    out = {name: _rebuild(tree, name, flat, used) for name, tree in item.items()}
    extra = sorted(k for k in flat if k.split(".")[0] in item and k not in used)
    if extra:
        raise ValueError(f"checkpoint.restore: the template has no place for {extra}")
    ret = [out["state"]]
    if graph_template is not None:
        ret.append(out["graph"])
    if extras_template is not None:
        ret.append(out["extras"])
    return ret[0] if len(ret) == 1 else tuple(ret)
