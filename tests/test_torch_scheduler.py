"""Port parity: every registered scheduler of `cat_tpu_torch.utils.
scheduler` against `cat_tpu.utils.scheduler`'s over the same sequences of
`update_lr_step` and `step(metric)` calls (metrics and step gaps drawn
from a seed, both directions of `reverse`), and `build_scheduler` on every
scheduler block of the recipes under `egs/`. Both are plain Python
arithmetic in the same order: the lr, the `State` names and the whole
`state_dict` must be exactly equal after every call."""
import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from cat_tpu.utils import scheduler as jax_sched
from cat_tpu_torch.utils import scheduler as port_sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KWARGS = {
    "Scheduler": dict(lr_init=1e-3),
    "SchedulerEarlyStop": dict(lr_init=5e-3, min_step=6, stop_lr=3e-4,
                               n_tol=1, gamma=0.3),
    "SchedulerFixedStop": dict(lr_init=3e-3, stop_step=25),
    "SchedulerEarlyStopWithWarmup": dict(lr_init=2e-3, warmup_step=8,
                                         stop_lr=1e-4, n_tol=0, gamma=0.5),
    "SchedulerNoam": dict(dim_model=64, warmup_step=10, stop_step=30,
                          peak_factor=5.0),
    "SchedulerNoamEarlyStop": dict(dim_model=64, warmup_step=10,
                                   peak_factor=5.0, stop_lr=1e-3, n_tol=0,
                                   gamma=0.5),
    "SchedulerLinearAnnealing": dict(lr_init=1e-2, min_step=5, stop_lr=1e-4,
                                     stop_step=30),
    "SchedulerCosineAnnealing": dict(lr_init=1e-2, min_lr=1e-4,
                                     stop_step=30, period=7,
                                     decay_factor=0.8),
}


def test_every_registered_scheduler_is_ported():
    assert sorted(port_sched._REGISTRY) == sorted(jax_sched._REGISTRY)
    assert sorted(KWARGS) == sorted(jax_sched._REGISTRY)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", sorted(KWARGS))
def test_scheduler_matches_jax(name, reverse):
    kw = dict(KWARGS[name], reverse=reverse)
    j = jax_sched._REGISTRY[name](**kw)
    p = port_sched._REGISTRY[name](**kw)
    assert p.state_dict() == j.state_dict() and p.lr == j.lr
    rng = np.random.default_rng(len(name) + reverse)
    n, metric = 0, 10.0
    states = []
    for _ in range(40):
        n += int(rng.integers(1, 3))
        j.update_lr_step(n)
        p.update_lr_step(n)
        assert p.lr == j.lr and p.state_dict() == j.state_dict(), n
        if rng.random() < 0.5:
            metric += float(rng.normal(0.0, 1.0))
            sj, sp = j.step(metric), p.step(metric)
            assert sp.name == sj.name, n
            assert p.lr == j.lr and p.state_dict() == j.state_dict(), n
            states.append(sp.name)
    assert "IMPROVED" in states and "CONTINUE" in states


def test_state_dict_round_trip():
    a = port_sched.SchedulerNoamEarlyStop(**KWARGS["SchedulerNoamEarlyStop"])
    for n, m in ((3, 2.0), (12, 2.5), (13, 2.6)):
        a.update_lr_step(n)
        a.step(m)
    b = port_sched.SchedulerNoamEarlyStop(**KWARGS["SchedulerNoamEarlyStop"])
    b.load_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict()
    for n in (14, 15):
        a.update_lr_step(n)
        b.update_lr_step(n)
        assert a.step(3.0) == b.step(3.0) and a.lr == b.lr


def test_noam_terminates_at_stop_step():
    """A Noam schedule ends the run: the first eval at or after stop_step
    returns TERMINATED (as crf-v1's Noam does at 40000 updates)."""
    s = port_sched.SchedulerNoam(dim_model=512, warmup_step=10,
                                 stop_step=40, peak_factor=5.0)
    for n in range(1, 40):
        s.update_lr_step(n)
        assert s.step(1.0 / n) != port_sched.State.TERMINATED
    s.update_lr_step(40)
    assert s.step(0.0) == port_sched.State.TERMINATED


def _scheduler_blocks():
    blocks = []
    for path in sorted(glob.glob(os.path.join(REPO, "egs/**/*.json"),
                                 recursive=True)):
        with open(path) as f:
            cfg = json.load(f)
        stack = [cfg]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                if "type" in node and "optimizer" in node:
                    blocks.append((os.path.relpath(path, REPO), node))
                stack.extend(node.values())
    return blocks


def test_build_scheduler_on_every_recipe():
    blocks = _scheduler_blocks()
    assert len(blocks) >= 20
    names = set()
    for where, cfg in blocks:
        js, _ = jax_sched.build_scheduler(cfg)
        w = torch.nn.Parameter(torch.zeros(3))
        ps, opt = port_sched.build_scheduler(cfg, [w])
        assert ps.state_dict() == js.state_dict(), where
        kw = cfg["optimizer"].get("kwargs", {})
        group = opt.param_groups[0]
        assert group["lr"] == kw.get("lr", 1e-3), where
        assert group["betas"] == tuple(kw.get("betas", (0.9, 0.999))), where
        for n in (1, 2, 100, 10 ** 6):
            js.update_lr_step(n)
            ps.update_lr_step(n)
            assert ps.lr == js.lr and math.isfinite(ps.lr), where
        assert ps.step(1.0).name == js.step(1.0).name, where
        names.add(cfg["type"])
    assert {"SchedulerNoam", "SchedulerEarlyStop", "SchedulerNoamEarlyStop",
            "SchedulerFixedStop"} <= names
