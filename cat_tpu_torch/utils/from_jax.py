"""Carry `cat_tpu` weights across: a JAX `ConformerNet`'s, `LSTM`'s,
`TDNN_NAS`'s, JoinAP encoder's, `EmbeddingEncoder`'s, JSA trainer's
(S2P, P2G and G2P), `TransducerModel`'s, CUSIDE unified
model's (`UnifiedEncoder`, `UnifiedTransducerModel`) or multichannel
model's (`Me2eModel`, `ChunkMe2eModel`, and the front end's modules
alone) variables, a P2G model's (`P2GSeq2Seq`: an `EmbeddingEncoder`
under a `TransformerDecoder`), or an LM's (`LSTMPredictor` with its head,
`Embedding`, `CausalTransformer`, `TRFNCE`) (nested dicts of numpy arrays, as in its checkpoints) to the
port's state_dict (`model_state_dict` picks the converter by the port's
model class).

Layouts handled:
- cells are `cell_{i}` subtrees, or one `cells` subtree whose leaves carry
  a leading num_cells axis (`scan_layers=true`); batch_stats alike;
- the subsampling is `Conv2dSubsampling_0`, or
  `CheckpointConv2dSubsampling_0` under `remat`, or `VGG2LSubsampling_0`
  (its four convs `Conv_0` .. `Conv_3`) with its projection `Dense_0`;
- a conformer without batch normalisation keeps no batch_stats (its conv
  modules' second LayerNorm takes their place);
- conv kernels HWIO -> OIHW; the depthwise kernel (k, 1, D) -> (D, 1, k);
  a TDNN layer's (k, in, out) -> (out, in, k);
- DenseGeneral kernels (D, H, Dh) and (H, Dh, D), and the projection's
  (F', C, D), flatten to (in, out) matrices in the same element order
  (flax's attention biases (H, Dh) to (D,)).
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
    sd.update(conv_module_state_dict(p["ConvModule_0"],
                                     stats.get("ConvModule_0", {}),
                                     pre + "conv."))


def conv_module_state_dict(c, s, pre=""):
    """The port's `ConvModule` state_dict (keys prefixed with `pre`) from
    a JAX ConvModule's params `c` and batch_stats `s`: with batch
    normalisation `bn_scale`, `bn_bias` and the running statistics;
    without it (`use_batchnorm=False`, no statistics) the second
    LayerNorm, `LayerNorm_1`, as `conv_norm`."""
    sd = {}
    _ln(sd, pre + "norm.", c["LayerNorm_0"])
    _dense(sd, pre + "pw_in.", c["Dense_0"])
    _dense(sd, pre + "pw_out.", c["Dense_1"])
    dw = np.asarray(c["Conv_0"]["kernel"])             # (k, 1, D)
    sd[pre + "depthwise.weight"] = _t(np.transpose(dw, (2, 1, 0)))
    sd[pre + "depthwise.bias"] = _t(c["Conv_0"]["bias"])
    if "bn_scale" not in c:
        _ln(sd, pre + "conv_norm.", c["LayerNorm_1"])
        return sd
    sd[pre + "bn_scale"] = _t(c["bn_scale"])
    sd[pre + "bn_bias"] = _t(c["bn_bias"])
    sd[pre + "running_mean"] = _t(s["mean"])
    sd[pre + "running_var"] = _t(s["var"])
    return sd


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _cells(params, batch_stats):
    """[(cell params, cell batch_stats)] in order, for either layout."""
    if "cells" in params:
        L = np.asarray(params["cells"]["LayerNorm_0"]["scale"]).shape[0]
        stats = batch_stats.get("cells", {})
        return [(_index(params["cells"], i), _index(stats, i))
                for i in range(L)]
    idx = _cell_indices(params)
    return [(params[f"cell_{i}"], batch_stats.get(f"cell_{i}", {}))
            for i in idx]


def _cell_indices(params):
    return sorted(int(m.group(1)) for k in params
                  if (m := re.fullmatch(r"cell_(\d+)", k)))


def initial_batch_stats(params):
    """flax's initial batch_stats (mean 0, var 1 in every conv module) for
    a JAX ConformerNet's `params`, in either layout: the statistics of a
    model whose trainer keeps none, as the JAX JSA trainer keeps none for
    its S2P."""
    def conv(c, lead=()):
        D = np.asarray(c["Conv_0"]["kernel"]).shape[-1]
        return {"ConvModule_0": {"mean": np.zeros(lead + (D,), np.float32),
                                 "var": np.ones(lead + (D,), np.float32)}}
    if "cells" in params:
        c = params["cells"]["ConvModule_0"]
        L = np.asarray(c["Conv_0"]["kernel"]).shape[0]
        return {"cells": conv(_index(c, 0), (L,))}
    return {f"cell_{i}": conv(params[f"cell_{i}"]["ConvModule_0"])
            for i in _cell_indices(params)}


def conformer_state_dict(params, batch_stats):
    """The port's `ConformerNet` state_dict from a `cat_tpu` ConformerNet's
    `params` and `batch_stats` trees (`batch_stats` empty or without cells
    for a conformer without batch normalisation)."""
    sd = {}
    batch_stats = batch_stats or {}
    sub = params.get("Conv2dSubsampling_0",
                     params.get("CheckpointConv2dSubsampling_0"))
    convs = (("conv_a", "conv_a"), ("conv_b", "conv_b"))
    if sub is None:
        sub = params.get("VGG2LSubsampling_0")
        if sub is None:
            raise KeyError("no Conv2dSubsampling_0 or VGG2LSubsampling_0 in "
                           "the parameters")
        convs = tuple((f"Conv_{i}", f"convs.{i}") for i in range(4))
        _dense(sd, "subsampling.proj.", params["Dense_0"])
    else:
        fq, C, D = np.asarray(sub["proj"]["kernel"]).shape  # (F', C, D)
        _dense(sd, "subsampling.proj.", sub["proj"], din=fq * C)
    for src, name in convs:
        k = np.asarray(sub[src]["kernel"])              # HWIO
        sd[f"subsampling.{name}.weight"] = _t(np.transpose(k, (3, 2, 0, 1)))
        sd[f"subsampling.{name}.bias"] = _t(sub[src]["bias"])
    for i, (p, s) in enumerate(_cells(params, batch_stats)):
        _cell(sd, f"cells.{i}.", p, s)
    if "classifier" in params:
        _dense(sd, "classifier.", params["classifier"])
    return sd



def embedding_encoder_state_dict(params, batch_stats=None):
    """The port's `EmbeddingEncoder` state_dict from a `cat_tpu` one's
    params: `Embed_0`, the cells `cell_{i}` (their conv modules with
    LayerNorm, `LayerNorm_0`, `Dense_0`, `Conv_0`, `LayerNorm_1`,
    `Dense_1`, when built without batch normalisation, which keeps no
    statistics; with it, their statistics from `batch_stats`), the
    classifier."""
    sd = {"embed.weight": _t(params["Embed_0"]["embedding"])}
    for i, (p, s) in enumerate(_cells(params, batch_stats or {})):
        _cell(sd, f"cells.{i}.", p, s)
    if "classifier" in params:
        _dense(sd, "classifier.", params["classifier"])
    return sd


def jsa_state_dict(model, params, batch_stats):
    """The port's `JsaModel` state_dict from a JAX JSA trainer's params
    {"s2p", "p2g", "g2p"}, each through the converter of the port's
    model. The JAX trainer keeps no batch_stats: a batch-normalised S2P
    (a ConformerNet) starts from flax's initial ones,
    `initial_batch_stats`, unless `batch_stats` holds an "s2p" tree."""
    stats = dict(batch_stats or {})
    if type(model.s2p).__name__ == "ConformerNet" and "s2p" not in stats:
        stats["s2p"] = initial_batch_stats(params["s2p"])
    sd = {}
    for name in ("s2p", "p2g", "g2p"):
        sub = encoder_state_dict(getattr(model, name), params[name],
                                 stats.get(name, {}))
        sd.update({f"{name}.{k}": v for k, v in sub.items()})
    return sd


def predictor_state_dict(params, pre=""):
    """The port's predictor or LM state_dict (keys prefixed with `pre`)
    from a JAX `LSTMPredictor`'s params (`embed`, `syl_embed`,
    `lstm_{i}_{wx,wh,b}`, `classifier`), an `Embedding`'s (`Embed_0`, its
    head `Dense_0`) or a `ZeroDecoder`'s (none)."""
    sd = {}
    for name, p in params.items():
        if name in ("embed", "Embed_0", "syl_embed"):
            emb = "syl_embed" if name == "syl_embed" else "embed"
            sd[pre + emb + ".weight"] = _t(p["embedding"])
        elif re.fullmatch(r"lstm_\d+_(wx|wh|b)", name):
            sd[pre + name] = _t(p)
        elif name in ("classifier", "Dense_0"):
            _dense(sd, pre + ("head." if name == "Dense_0" else
                              "classifier."), p)
        else:
            raise KeyError(f"predictor parameter {name!r} is not ported")
    return sd


def causal_transformer_state_dict(params, pre=""):
    """The port's `CausalTransformer` state_dict from a JAX one's params:
    `embed`, `pos_embed`, the blocks' `ln1_{i}`, `attn_{i}` (flax's
    SelfAttention: `query`, `key`, `value` kernels (D, H, Dh) and the
    `out` kernel (H, Dh, D) as (D, D) matrices), `ln2_{i}`, `ff1_{i}`,
    `ff2_{i}`, then `ln_f` and the untied `head`."""
    sd = {pre + "embed.weight": _t(params["embed"]["embedding"]),
          pre + "pos_embed": _t(params["pos_embed"])}
    for i in _layer_indices(params, "attn"):
        _transformer_block(sd, f"{pre}blocks.{i}.", params, i, "attn")
    _ln(sd, pre + "ln_f.", params["ln_f"])
    if "head" in params:
        _dense(sd, pre + "head.", params["head"])
    return sd


def _layer_indices(params, attn):
    return sorted(int(m.group(1)) for k in params
                  if (m := re.fullmatch(attn + r"_(\d+)", k)))


def _mha(sd, pre, a):
    """flax's attention: the `query`, `key`, `value` kernels (D', H, Dh)
    and the `out` kernel (H, Dh, D) as matrices, the biases flattened."""
    for name, src in (("q", "query"), ("k", "key"), ("v", "value")):
        _dense(sd, f"{pre}{name}.", a[src])
    H, Dh, _ = np.asarray(a["out"]["kernel"]).shape
    _dense(sd, pre + "out.", a["out"], din=H * Dh)


def _transformer_block(sd, b, params, i, attn):
    """Layer i of a JAX transformer: `ln1_{i}`, the attention `{attn}_{i}`,
    `ln2_{i}`, `ff1_{i}`, `ff2_{i}`."""
    _ln(sd, b + "ln1.", params[f"ln1_{i}"])
    _mha(sd, b, params[f"{attn}_{i}"])
    _ln(sd, b + "ln2.", params[f"ln2_{i}"])
    _dense(sd, b + "ff1.", params[f"ff1_{i}"])
    _dense(sd, b + "ff2.", params[f"ff2_{i}"])


def transformer_decoder_state_dict(params, pre=""):
    """The port's `TransformerDecoder` state_dict from a JAX one's params:
    `embed`, `pos_embed`, each layer's `ln1_{i}`, `self_{i}`, the cross
    attention `lnx_{i}` and `cross_{i}` (made by a call with memory),
    `ln2_{i}`, `ff1_{i}`, `ff2_{i}`, then `ln_f` and `head`."""
    sd = {pre + "embed.weight": _t(params["embed"]["embedding"]),
          pre + "pos_embed": _t(params["pos_embed"])}
    for i in _layer_indices(params, "self"):
        b = f"{pre}blocks.{i}."
        _transformer_block(sd, b, params, i, "self")
        _ln(sd, b + "lnx.", params[f"lnx_{i}"])
        _mha(sd, b + "cross.", params[f"cross_{i}"])
    _ln(sd, pre + "ln_f.", params["ln_f"])
    if "head" in params:
        _dense(sd, pre + "head.", params["head"])
    return sd


def p2g_state_dict(params):
    """The port's `P2GSeq2Seq` state_dict from a JAX one's params: the
    `encoder` (an `EmbeddingEncoder` without batch normalisation) and the
    `decoder`."""
    sd = {"encoder." + k: v for k, v in
          embedding_encoder_state_dict(params["encoder"]).items()}
    sd.update(transformer_decoder_state_dict(params["decoder"], "decoder."))
    return sd


def lm_state_dict(model, params, pre=""):
    """The state_dict of the port's LM `model` (an `LSTMPredictor`, an
    `Embedding` or a `CausalTransformer`) from the JAX LM's params."""
    if type(model).__name__ == "CausalTransformer":
        return causal_transformer_state_dict(params, pre)
    return predictor_state_dict(params, pre)


def trf_state_dict(model, params):
    """The port's `TRFNCE` state_dict from a JAX one's params: the energy
    network `udlying_nn`, the noise LM `noise_model`, `zeta` and, for the
    hidden2scalar energy, `energy_lin`."""
    sd = {"zeta": _t(params["zeta"])}
    for name in ("udlying_nn", "noise_model"):
        sd.update(lm_state_dict(getattr(model, name), params[name],
                                name + "."))
    if "energy_lin" in params:
        _dense(sd, "energy_lin.", params["energy_lin"])
    return sd


def joiner_state_dict(params, pre=""):
    """The port's joiner state_dict from a JAX joiner's params: its
    `fc_enc`, `fc_pred`, `fc_cat` and `fc_out` dense layers, whichever it
    has."""
    sd = {}
    for name, p in params.items():
        _dense(sd, f"{pre}{name}.", p)
    return sd


def lstm_encoder_state_dict(params, bidirectional=True):
    """The port's `LSTM` encoder state_dict from a `cat_tpu` LSTM's
    `params`: the cells `LSTMStack_0/OptimizedLSTMCell_{k}`, numbered in
    the order they were built (layer by layer, the forward direction
    before the reverse one), each gate's kernels concatenated in the
    order i, f, g, o; then the classifier. An LSTM has no batch_stats."""
    stack = params["LSTMStack_0"]
    n = len([k for k in stack if re.fullmatch(r"OptimizedLSTMCell_\d+", k)])
    dirs = 2 if bidirectional else 1
    sd = {}
    for k in range(n):
        cell = stack[f"OptimizedLSTMCell_{k}"]
        pre = f"layers.{k // dirs}.{k % dirs}."
        for name, kind, part in (("wi", "i", "kernel"), ("wh", "h", "kernel"),
                                 ("b", "h", "bias")):
            sd[pre + name] = _t(np.concatenate(
                [np.asarray(cell[kind + g][part]) for g in "ifgo"], -1))
    if "classifier" in params:
        _dense(sd, "classifier.", params["classifier"])
    return sd


def tdnn_state_dict(params):
    """The port's `TDNN_NAS` state_dict from a `cat_tpu` TDNN_NAS's
    `params`: the layers `tdnn_{i}/Conv_0`, then the classifier."""
    sd = {}
    idx = sorted(int(m.group(1)) for k in params
                 if (m := re.fullmatch(r"tdnn_(\d+)", k)))
    for i in idx:
        conv = params[f"tdnn_{i}"]["Conv_0"]
        k = np.asarray(conv["kernel"])                  # (k, in, out)
        sd[f"layers.{i}.conv.weight"] = _t(np.transpose(k, (2, 1, 0)))
        sd[f"layers.{i}.conv.bias"] = _t(conv["bias"])
    if "classifier" in params:
        _dense(sd, "classifier.", params["classifier"])
    return sd


def joinap_state_dict(encoder, params, batch_stats):
    """The port's JoinAP encoder's state_dict from a `cat_tpu`
    JoinAPLinearEncoder's or JoinAPNonLinearEncoder's variables: the
    `enc_head` subtree through the converter of the port's head, then `A`,
    or `A1` and `A2`. P is no parameter in either package."""
    head = encoder_state_dict(encoder.enc_head, params["enc_head"],
                              (batch_stats or {}).get("enc_head", {}))
    sd = {"enc_head." + k: v for k, v in head.items()}
    for name in ("A", "A1", "A2"):
        if name in params:
            _dense(sd, name + ".", params[name])
    return sd


def encoder_state_dict(encoder, params, batch_stats):
    """The state_dict of the port's `encoder` (a `ConformerNet`, an
    `LSTM`, a `TDNN_NAS`, a JoinAP encoder or an `EmbeddingEncoder`) from
    the JAX encoder's
    `params` and `batch_stats` trees."""
    name = type(encoder).__name__
    if name == "ConformerNet":
        return conformer_state_dict(params, batch_stats)
    if name == "LSTM":
        return lstm_encoder_state_dict(params, encoder.bidirectional)
    if name == "TDNN_NAS":
        return tdnn_state_dict(params)
    if name in ("JoinAPLinearEncoder", "JoinAPNonLinearEncoder"):
        return joinap_state_dict(encoder, params, batch_stats)
    if name == "EmbeddingEncoder":
        return embedding_encoder_state_dict(params, batch_stats)
    raise NotImplementedError(f"no converter of JAX weights for {name}")


def model_state_dict(model, params, batch_stats):
    """The state_dict of the port's `model` (an encoder, a
    `TransducerModel`, a unified model, an LM, a `TRFNCE`, an ME2E, JSA
    or P2G model) from the JAX model's variables."""
    name = type(model).__name__
    if name in ("LSTMPredictor", "Embedding", "CausalTransformer"):
        return lm_state_dict(model, params)
    if name == "TRFNCE":
        return trf_state_dict(model, params)
    if name == "TransducerModel":
        return transducer_state_dict(params, batch_stats, model.encoder)
    if name in ("UnifiedEncoder", "UnifiedTransducerModel"):
        return unified_state_dict(model, params, batch_stats)
    if name in ("Me2eModel", "ChunkMe2eModel"):
        return me2e_state_dict(model, params, batch_stats)
    if name in _FRONT:
        return _FRONT[name](params)
    if name == "JsaModel":
        return jsa_state_dict(model, params, batch_stats)
    if name == "P2GSeq2Seq":
        return p2g_state_dict(params)
    return encoder_state_dict(model, params, batch_stats)


def simunet_state_dict(params, pre=""):
    """The port's `SimuNet` state_dict from a JAX SimuNet's params: the
    GRU cell (`GRUCell_0`, or `RNN_0/cell`) with its kernels transposed
    and stacked in torch's gate order (r, z, n), bias_ih = (ir, iz, in)
    and bias_hh = (0, 0, hn), flax's cell having no hr and hz biases;
    then `Dense_0`, the output layer."""
    cell = params.get("GRUCell_0") or params["RNN_0"]["cell"]
    k = lambda g: np.asarray(cell[g]["kernel"]).T
    b = lambda g: np.asarray(cell[g]["bias"])
    hn = b("hn")
    sd = {pre + "gru.weight_ih_l0": _t(np.concatenate([k("ir"), k("iz"),
                                                       k("in")])),
          pre + "gru.weight_hh_l0": _t(np.concatenate([k("hr"), k("hz"),
                                                       k("hn")])),
          pre + "gru.bias_ih_l0": _t(np.concatenate([b("ir"), b("iz"),
                                                     b("in")])),
          pre + "gru.bias_hh_l0": _t(np.concatenate(
              [np.zeros(2 * hn.shape[0], np.float32), hn]))}
    _dense(sd, pre + "out.", params["Dense_0"])
    return sd


def unified_state_dict(model, params, batch_stats):
    """The state_dict of the port's CUSIDE `model` from the JAX one's
    variables: a `UnifiedEncoder` (the CTC bin: `encoder`, its classifier
    included, and `simu`) or a `UnifiedTransducerModel` (`uenc` holding
    both, then the predictor and the joiner)."""
    stats = batch_stats or {}
    if type(model).__name__ == "UnifiedTransducerModel":
        sd = {"uenc." + k: v for k, v in unified_state_dict(
            model.uenc, params["uenc"], stats.get("uenc", {})).items()}
        sd.update(predictor_state_dict(params.get("predictor", {}),
                                       "predictor."))
        sd.update(joiner_state_dict(params["joiner"], "joiner."))
        return sd
    enc = encoder_state_dict(model.encoder, params["encoder"],
                             stats.get("encoder", {}))
    sd = {"encoder." + k: v for k, v in enc.items()}
    if model.simu is not None:
        sd.update(simunet_state_dict(params["simu"], "simu."))
    return sd


def transducer_state_dict(params, batch_stats, encoder=None):
    """The port's `TransducerModel` state_dict from a `cat_tpu`
    TransducerModel's `params` and `batch_stats` trees: the encoder (the
    port's `encoder` module tells its kind; None: a `ConformerNet`, either
    cell layout), then the predictor and the joiner."""
    stats = (batch_stats or {}).get("encoder", {})
    enc = (conformer_state_dict(params["encoder"], stats) if encoder is None
           else encoder_state_dict(encoder, params["encoder"], stats))
    sd = {"encoder." + k: v for k, v in enc.items()}
    sd.update(predictor_state_dict(params.get("predictor", {}),
                                   "predictor."))
    sd.update(joiner_state_dict(params["joiner"], "joiner."))
    return sd


def masknet_state_dict(params, pre=""):
    """The port's `MaskNet` state_dict from a JAX one's params: its BLSTM
    `LSTMStack_0` (as an `LSTM` encoder's, under "lstm.") and the
    `speech` and `noise` heads."""
    sd = {pre + "lstm." + k: v for k, v in
          lstm_encoder_state_dict(params, bidirectional=True).items()}
    _dense(sd, pre + "speech.", params["speech"])
    _dense(sd, pre + "noise.", params["noise"])
    return sd


def dnn_wpe_state_dict(params, pre=""):
    """The port's `DnnWpe` state_dict: its own `MaskNet_0`."""
    return masknet_state_dict(params["MaskNet_0"], pre + "mask.")


def beamformer_state_dict(params, pre=""):
    """The port's `BeamformerNet` state_dict from a JAX one's params:
    `DnnWpe_0` (DNN-WPE) and `MaskNet_0`, whichever it has (a `noSE`
    front end has neither)."""
    sd = {}
    if "DnnWpe_0" in params:
        sd.update(dnn_wpe_state_dict(params["DnnWpe_0"], pre + "dnn_wpe."))
    if "MaskNet_0" in params:
        sd.update(masknet_state_dict(params["MaskNet_0"], pre + "mask."))
    return sd


def neural_filter_state_dict(params, pre=""):
    """The port's `NeuralFilter` state_dict: the BLSTM `LSTMStack_0` and
    the `filt_re` and `filt_im` heads."""
    sd = {pre + "lstm." + k: v for k, v in
          lstm_encoder_state_dict(params, bidirectional=True).items()}
    _dense(sd, pre + "filt_re.", params["filt_re"])
    _dense(sd, pre + "filt_im.", params["filt_im"])
    return sd


_FRONT = {"BeamformerNet": beamformer_state_dict,
          "MaskNet": masknet_state_dict, "DnnWpe": dnn_wpe_state_dict,
          "NeuralFilter": neural_filter_state_dict}


def me2e_state_dict(model, params, batch_stats):
    """The state_dict of the port's `Me2eModel` or `ChunkMe2eModel` from
    the JAX model's variables: `frontend`, `encoder` (through the
    converter of the port's encoder, its classifier included) and, for
    the chunk model, `simu`."""
    sd = {"frontend." + k: v for k, v in
          beamformer_state_dict(params.get("frontend", {})).items()}
    enc = encoder_state_dict(model.encoder, params["encoder"],
                             (batch_stats or {}).get("encoder", {}))
    sd.update({"encoder." + k: v for k, v in enc.items()})
    if getattr(model, "simu", None) is not None:
        sd.update(simunet_state_dict(params["simu"], "simu."))
    return sd
