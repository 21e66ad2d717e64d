"""Checkpoints: the port's writer and reader, the reader of `cat_tpu`'s,
the `checkpoint.list` index with its retention, and averaging
(counterpart of `cat_tpu/utils/checkpoint.py`).

The port writes a checkpoint with `torch.save` (a zip archive of state
dicts: the model's, the optimizer's, the fold accumulator, the
scheduler's `__dict__`, the step counters), first to `path.tmp`, then
moved over `path` with `os.replace`, so a reader never sees half a file.
It reads them back with `torch.load(weights_only=True)`, onto the CPU.

A checkpoint of the JAX package is a pickle of a dict whose "state" is a
`flax.struct` TrainState (params, batch_stats, optax states, step) with
numpy leaves. Unpickling it plainly would import `cat_tpu`, flax, optax
and jax. `load_checkpoint` maps every class of those packages to a
stand-in that keeps its constructor arguments and its state, so the numpy
trees can be read (`model_variables`).
"""
from __future__ import annotations

import os
import pickle
import zipfile

import torch

_FOREIGN = ("cat_tpu.", "flax.", "optax.", "jax.", "jaxlib.")


class Stub:
    """Stand-in for a class of the JAX stack found in a checkpoint."""

    origin = ""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.__dict__["_args"] = args
        obj.__dict__["_state"] = {}
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:  # (dict, slots)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.__dict__["_state"] = state

    def __getattr__(self, name):
        state = self.__dict__.get("_state")
        if isinstance(state, dict) and name in state:
            return state[name]
        raise AttributeError(f"{self.origin} stand-in has no {name!r}")

    def __repr__(self):
        return f"Stub({self.origin})"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] + "." in _FOREIGN:
            return type(name, (Stub,), {"origin": f"{module}.{name}"})
        return super().find_class(module, name)


def save_checkpoint(path, state: dict):
    """Write `state` (nested dicts and lists of tensors and plain values)
    to `path` atomically: `torch.save` to `path.tmp`, then `os.replace`."""
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def is_port_checkpoint(path) -> bool:
    """True for a file `save_checkpoint` wrote (a zip archive), false for a
    pickle of the JAX package."""
    return zipfile.is_zipfile(path)


def load_checkpoint(path) -> dict:
    """Read a checkpoint of either package: the port's with its tensors on
    the CPU; the JAX package's unpickled with the classes of the JAX stack
    as `Stub`s. Read only files this toolkit wrote."""
    if is_port_checkpoint(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def model_weights(model, path) -> dict:
    """The state_dict for the port's `model` held by the checkpoint at
    `path`: a checkpoint of the port's own, or one of the JAX package whose
    params and batch_stats `utils/from_jax.py` converts."""
    ck = load_checkpoint(path)
    if is_port_checkpoint(path):
        return ck["state"]["model"]
    from cat_tpu_torch.utils.from_jax import model_state_dict
    return model_state_dict(model, *model_variables(ck["state"]))


def plain_tree(tree):
    """Nested dicts of arrays from a params or batch_stats tree, with a
    stand-in mapping (a FrozenDict) unwrapped to its dict."""
    if isinstance(tree, Stub):
        args = tree.__dict__["_args"]
        if len(args) == 1 and isinstance(args[0], dict):
            return plain_tree(args[0])
        raise TypeError(f"cannot read {tree!r} as a parameter tree")
    if isinstance(tree, dict):
        return {k: plain_tree(v) for k, v in tree.items()}
    return tree


def model_variables(state):
    """(params, batch_stats) of a checkpoint's "state": a TrainState
    stand-in or a plain dict."""
    if isinstance(state, dict):
        return plain_tree(state["params"]), plain_tree(
            state.get("batch_stats") or {})
    return plain_tree(state.params), plain_tree(
        getattr(state, "batch_stats", None) or {})


class CheckpointManager:
    """A checkpoint directory with an append-only `checkpoint.list` index
    (name, metric, step per line, tab-separated) and its retention: after
    each save only the last `keep_last` and the `keep_best` of least metric
    stay on disk. The names and lines are the JAX package's, so either
    package reads the other's index."""

    def __init__(self, ckpt_dir, keep_last=5, keep_best=3):
        self.dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self.index_path = os.path.join(ckpt_dir, "checkpoint.list")
        self.keep_last = keep_last
        self.keep_best = keep_best
        self.entries = []  # (name, metric, step)
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                for line in f:
                    parts = line.split("\t")
                    if len(parts) == 3:
                        self.entries.append(
                            (parts[0], float(parts[1]), int(parts[2])))

    def path(self, name):
        return os.path.join(self.dir, name)

    def save(self, state: dict, metric: float, step: int, epoch: int):
        name = f"checkpoint.{epoch:03d}e{step:08d}s.pt"
        save_checkpoint(self.path(name), state)
        self.entries.append((name, float(metric), int(step)))
        with open(self.index_path, "a") as f:
            f.write(f"{name}\t{metric:.8f}\t{step}\n")
        self._prune()
        return name

    def _prune(self):
        if not self.entries:
            return
        by_recency = [e[0] for e in self.entries[-self.keep_last:]]
        by_metric = [e[0] for e in sorted(self.entries, key=lambda e: e[1])
                     [: self.keep_best]]
        keep = set(by_recency) | set(by_metric)
        for name, _, _ in self.entries:
            p = self.path(name)
            if name not in keep and os.path.exists(p):
                os.remove(p)

    def _available(self):
        return [e for e in self.entries if os.path.exists(self.path(e[0]))]

    def best(self):
        """The name of the checkpoint of least metric still on disk."""
        avail = self._available()
        return min(avail, key=lambda e: e[1])[0] if avail else None

    def last(self):
        """The name of the newest checkpoint still on disk."""
        avail = self._available()
        return avail[-1][0] if avail else None


def average_checkpoints(paths):
    """Uniform average of the model state dicts of the port's checkpoints
    at `paths`: float tensors summed in float64 and returned in float32,
    any other entry taken from the first (it must be equal in all)."""
    acc, n = None, 0
    for p in paths:
        tree = load_checkpoint(p)["state"]["model"]
        if acc is None:
            acc = {k: v.double() if v.is_floating_point() else v
                   for k, v in tree.items()}
        else:
            for k, v in tree.items():
                if v.is_floating_point():
                    acc[k] += v.double()
                elif not torch.equal(acc[k], v):
                    raise ValueError(f"{p}: {k} differs between the "
                                     "checkpoints and cannot be averaged")
        n += 1
    if acc is None:
        raise ValueError("average_checkpoints: no paths")
    return {k: (v / n).float() if v.is_floating_point() else v
            for k, v in acc.items()}
