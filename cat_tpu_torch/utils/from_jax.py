"""Carry `cat_tpu` weights across: a JAX `ConformerNet`'s variables (nested
dicts of numpy arrays, as in its checkpoints) to the port's state_dict.

Layouts handled:
- cells are `cell_{i}` subtrees, or one `cells` subtree whose leaves carry
  a leading num_cells axis (`scan_layers=true`); batch_stats alike;
- the subsampling is `Conv2dSubsampling_0`, or
  `CheckpointConv2dSubsampling_0` under `remat`;
- conv kernels HWIO -> OIHW; the depthwise kernel (k, 1, D) -> (D, 1, k);
- DenseGeneral kernels (D, H, Dh) and (H, Dh, D), and the projection's
  (F', C, D), flatten to (in, out) matrices in the same element order.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(a, shape=None):
    a = np.asarray(a, np.float32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(a.copy())


def _dense(sd, prefix, p, din=None):
    k = np.asarray(p["kernel"])
    din = din or k.shape[0]
    sd[prefix + "kernel"] = _t(k, (din, -1))
    if "bias" in p:
        sd[prefix + "bias"] = _t(p["bias"], (-1,))


def _ln(sd, prefix, p):
    sd[prefix + "weight"] = _t(p["scale"])
    sd[prefix + "bias"] = _t(p["bias"])


def _cell(sd, pre, p, stats):
    for name, src in (("ff1", "FFModule_0"), ("ff2", "FFModule_1")):
        _ln(sd, f"{pre}{name}.norm.", p[src]["LayerNorm_0"])
        _dense(sd, f"{pre}{name}.fc1.", p[src]["Dense_0"])
        _dense(sd, f"{pre}{name}.fc2.", p[src]["Dense_1"])
    _ln(sd, pre + "norm_mhsa.", p["LayerNorm_0"])
    _ln(sd, pre + "norm_out.", p["LayerNorm_1"])
    a = p["RelPositionMultiHeadAttention_0"]
    D = np.asarray(a["q"]["kernel"]).shape[0]
    for name in ("q", "k", "v", "pos", "out"):
        _dense(sd, f"{pre}mhsa.{name}.", a[name], din=D)
    sd[pre + "mhsa.u_bias"] = _t(a["u_bias"])
    sd[pre + "mhsa.v_bias"] = _t(a["v_bias"])
    c = p["ConvModule_0"]
    _ln(sd, pre + "conv.norm.", c["LayerNorm_0"])
    _dense(sd, pre + "conv.pw_in.", c["Dense_0"])
    _dense(sd, pre + "conv.pw_out.", c["Dense_1"])
    dw = np.asarray(c["Conv_0"]["kernel"])             # (k, 1, D)
    sd[pre + "conv.depthwise.weight"] = _t(np.transpose(dw, (2, 1, 0)))
    sd[pre + "conv.depthwise.bias"] = _t(c["Conv_0"]["bias"])
    sd[pre + "conv.bn_scale"] = _t(c["bn_scale"])
    sd[pre + "conv.bn_bias"] = _t(c["bn_bias"])
    s = stats["ConvModule_0"]
    sd[pre + "conv.running_mean"] = _t(s["mean"])
    sd[pre + "conv.running_var"] = _t(s["var"])


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _cells(params, batch_stats):
    """[(cell params, cell batch_stats)] in order, for either layout."""
    if "cells" in params:
        L = np.asarray(params["cells"]["LayerNorm_0"]["scale"]).shape[0]
        return [(_index(params["cells"], i), _index(batch_stats["cells"], i))
                for i in range(L)]
    idx = sorted(int(m.group(1)) for k in params
                 if (m := re.fullmatch(r"cell_(\d+)", k)))
    return [(params[f"cell_{i}"], batch_stats[f"cell_{i}"]) for i in idx]


def conformer_state_dict(params, batch_stats):
    """The port's `ConformerNet` state_dict from a `cat_tpu` ConformerNet's
    `params` and `batch_stats` trees."""
    sd = {}
    sub = params.get("Conv2dSubsampling_0",
                     params.get("CheckpointConv2dSubsampling_0"))
    if sub is None:
        raise KeyError("no Conv2dSubsampling_0 in the parameters: only the "
                       "conv2d subsampling is ported")
    for name in ("conv_a", "conv_b"):
        k = np.asarray(sub[name]["kernel"])             # HWIO
        sd[f"subsampling.{name}.weight"] = _t(np.transpose(k, (3, 2, 0, 1)))
        sd[f"subsampling.{name}.bias"] = _t(sub[name]["bias"])
    fq, C, D = np.asarray(sub["proj"]["kernel"]).shape  # (F', C, D)
    _dense(sd, "subsampling.proj.", sub["proj"], din=fq * C)
    for i, (p, s) in enumerate(_cells(params, batch_stats)):
        _cell(sd, f"cells.{i}.", p, s)
    if "classifier" in params:
        _dense(sd, "classifier.", params["classifier"])
    return sd
