"""Reading `cat_tpu` checkpoints without JAX.

A checkpoint of the JAX package is a pickle of a dict whose "state" is a
`flax.struct` TrainState (params, batch_stats, optax states, step) with
numpy leaves (`cat_tpu/utils/checkpoint.py`). Unpickling it plainly would
import `cat_tpu`, flax, optax and jax. `load_checkpoint` maps every class
of those packages to a stand-in that keeps its constructor arguments and
its state, so the numpy trees can be read. `CheckpointManager` reads the
`checkpoint.list` index to find the best checkpoint.
"""
from __future__ import annotations

import os
import pickle

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


def load_checkpoint(path) -> dict:
    """Unpickle a checkpoint written by either package; classes of the JAX
    stack come back as `Stub`s. Read only files this toolkit wrote."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


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
    """Reader of a checkpoint directory's append-only `checkpoint.list`
    index (name, metric, step per line): `best()` names the checkpoint of
    least metric that is still on disk."""

    def __init__(self, ckpt_dir):
        self.dir = ckpt_dir
        self.entries = []  # (name, metric, step)
        index = os.path.join(ckpt_dir, "checkpoint.list")
        if os.path.exists(index):
            with open(index) as f:
                for line in f:
                    parts = line.split("\t")
                    if len(parts) == 3:
                        self.entries.append(
                            (parts[0], float(parts[1]), int(parts[2])))

    def path(self, name):
        return os.path.join(self.dir, name)

    def _available(self):
        return [e for e in self.entries if os.path.exists(self.path(e[0]))]

    def best(self):
        avail = self._available()
        return min(avail, key=lambda e: e[1])[0] if avail else None
