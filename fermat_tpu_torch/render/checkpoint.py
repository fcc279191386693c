"""Checkpoint / resume for progressive rendering (fermat_tpu/render/checkpoint.py).

The reference resumes only from `-save-intermediate` TGA snapshots
(main.cu:171-181). Here a RenderingContext's whole accumulation state, the
framebuffer, the pass counter and a stateful renderer's state (PSSMLT's and
cmlt's chains, psfpt's hash cells, ptrl's Q table, clusters and light cut),
round-trips through one .npz, so that a context restored after N passes and
rendered M more equals one rendered N + M passes.

Format, as JAX's: the state's leaves as `leaf_<i>` arrays, and a structure
guard. No pickle: the structure is JSON (`structure`), each node a tuple,
list, dict, NamedTuple, dataclass or plain object of a fermat_tpu_torch
class (rebuilt by its module path and name, nothing else is imported), or a
Python scalar; each leaf a tensor (restored onto the context's device) or a
numpy array. A file of another renderer, a framebuffer of another size, a
class outside the package or a state unlike the one the context holds
raises ValueError.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import List

import numpy as np
import torch

_PACKAGE = "fermat_tpu_torch"


def _class_name(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def _flatten(obj, leaves: List[np.ndarray]):
    """A JSON-able spec of obj; its arrays appended to `leaves`."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj.detach().cpu().numpy())
        return {"t": "tensor", "i": len(leaves) - 1}
    if isinstance(obj, np.ndarray):
        leaves.append(obj)
        return {"t": "ndarray", "i": len(leaves) - 1}
    if isinstance(obj, np.generic):
        leaves.append(np.asarray(obj))
        return {"t": "npscalar", "i": len(leaves) - 1}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"t": "namedtuple", "cls": _class_name(obj),
                "f": {k: _flatten(getattr(obj, k), leaves) for k in obj._fields}}
    if isinstance(obj, (tuple, list)):
        return {"t": type(obj).__name__, "items": [_flatten(x, leaves) for x in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise ValueError("checkpoint: a dict of the state has a key that is not a str")
        return {"t": "dict", "f": {k: _flatten(v, leaves) for k, v in obj.items()}}
    if type(obj).__module__.startswith(_PACKAGE + "."):
        kind = "dataclass" if dataclasses.is_dataclass(obj) else "object"
        return {"t": kind, "cls": _class_name(obj),
                "f": {k: _flatten(v, leaves) for k, v in vars(obj).items()}}
    raise ValueError(f"checkpoint: cannot store a {type(obj).__qualname__}")


def _resolve(name: str):
    module, qualname = name.split(":")
    if not (module == _PACKAGE or module.startswith(_PACKAGE + ".")):
        raise ValueError(f"checkpoint: class {name} is not the port's")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _unflatten(spec, data, device):
    t = spec["t"]
    if t in ("tensor", "ndarray", "npscalar"):
        a = data[f"leaf_{spec['i']}"]
        if t == "tensor":
            return torch.from_numpy(np.array(a)).to(device)
        return a if t == "ndarray" else a[()]
    if t == "py":
        return spec["v"]
    if t in ("tuple", "list"):
        items = [_unflatten(x, data, device) for x in spec["items"]]
        return tuple(items) if t == "tuple" else items
    if t == "dict":
        return {k: _unflatten(v, data, device) for k, v in spec["f"].items()}
    fields = {k: _unflatten(v, data, device) for k, v in spec["f"].items()}
    cls = _resolve(spec["cls"])
    if t == "namedtuple":
        return cls(**fields)
    obj = object.__new__(cls)
    obj.__dict__.update(fields)
    return obj


def _skeleton(spec, shapes):
    """The spec with Python values and leaf numbers left out; leaves as
    (kind, shape, dtype) from `shapes` (leaf index -> (shape, dtype))."""
    t = spec["t"]
    if t in ("tensor", "ndarray", "npscalar"):
        return [t, *shapes[spec["i"]]]
    if t == "py":
        return ["py"]
    if t in ("tuple", "list"):
        return [t, [_skeleton(x, shapes) for x in spec["items"]]]
    return [t, spec.get("cls"), {k: _skeleton(v, shapes) for k, v in spec["f"].items()}]


def _leaf_shapes(leaves):
    return {i: (list(a.shape), str(a.dtype)) for i, a in enumerate(leaves)}


def save_checkpoint(path: str, ctx) -> None:
    """Snapshot a RenderingContext's accumulation state to `path` (.npz)."""
    leaves: List[np.ndarray] = []
    spec = _flatten({"fb": ctx.fb, "renderer_state": ctx.renderer_state}, leaves)
    payload = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    payload["instance"] = np.asarray(ctx.instance)
    payload["structure"] = np.asarray(json.dumps(spec))
    payload["renderer"] = np.asarray(ctx.renderer)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, ctx) -> None:
    """Restore the accumulation state into a context of the same renderer
    and resolution; raises ValueError on a mismatch."""
    with np.load(path, allow_pickle=False) as data:
        saved = str(data["renderer"])
        if saved != ctx.renderer:
            raise ValueError(f"checkpoint renderer {saved!r} != context {ctx.renderer!r}")
        spec = json.loads(str(data["structure"]))
        if spec.get("t") != "dict" or set(spec["f"]) != {"fb", "renderer_state"}:
            raise ValueError("checkpoint state structure mismatch")
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        shapes = {i: (list(data[f"leaf_{i}"].shape), str(data[f"leaf_{i}"].dtype))
                  for i in range(n_leaves)}
        mine: List[np.ndarray] = []
        want = {"fb": _flatten(ctx.fb, mine)}
        if ctx.renderer_state is not None:
            want["renderer_state"] = _flatten(ctx.renderer_state, mine)
        try:
            for k, w in want.items():
                if _skeleton(spec["f"][k], shapes) != _skeleton(w, _leaf_shapes(mine)):
                    raise ValueError(f"checkpoint {k} structure mismatch")
            state = _unflatten(spec, data, ctx.device)
        except (KeyError, TypeError, AttributeError, ImportError) as e:
            raise ValueError(f"checkpoint state structure mismatch: {e!r}") from e
        instance = int(data["instance"])
    ctx.fb = state["fb"]
    ctx.renderer_state = state["renderer_state"]
    ctx.instance = instance
