"""RNN-T joint networks in PyTorch (counterparts of `JointNet`, `HAT` and
`LogAdd` in `cat_tpu/models/joiner.py`).

They compute in float32: the JAX modules' `nn.Dense` promotes the bf16
encoder output against its float32 parameters. A joiner takes encoder
frames (N, T, De) and predictor states (N, U+1, Dp) for training, giving
the (N, T, U+1, V) lattice, or equal-rank decode-step rows (N, De) and
(N, Dp), giving (N, V). Each side is projected on its own and the two are
broadcast-added, so no (N, T, U+1, De + Dp) concatenation is built: the
"cat" mode splits its kernel into the encoder's and the predictor's rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.models.encoders import init_weights
from cat_tpu_torch.models.layers import Dense

_ACTS = {"tanh": torch.tanh, "relu": torch.relu}


def _f32(x):
    return x.to(torch.float32)


def _join(e, p):
    """e (N, T, H) and p (N, U+1, H) broadcast to (N, T, U+1, H); equal-rank
    decode rows add as they are."""
    return e[:, :, None, :] + p[:, None, :, :] if e.dim() == 3 else e + p


class JointNet(nn.Module):
    """fc(enc) ⊕ fc(pred) -> act -> fc_out -> V logits."""

    def __init__(self, odim, hdim=512, join_mode="add", act="tanh", denc=512,
                 dpred=640, generator=None):
        super().__init__()
        if join_mode not in ("add", "cat"):
            raise ValueError(join_mode)
        self.join_mode = join_mode
        self.act = _ACTS[act]
        if join_mode == "add":
            self.fc_enc = Dense(denc, hdim)
            self.fc_pred = Dense(dpred, hdim)
        else:
            self.fc_cat = Dense(denc + dpred, hdim)
            self.denc = denc
        self.fc_out = Dense(hdim, odim)
        init_weights(self, generator)

    def hidden(self, enc, pred):
        f32 = torch.float32
        if self.join_mode == "add":
            e = self.fc_enc(_f32(enc), f32)
            p = self.fc_pred(_f32(pred), f32)
        else:
            k = self.fc_cat.kernel
            e = _f32(enc) @ k[:self.denc] + self.fc_cat.bias
            p = _f32(pred) @ k[self.denc:]
        return self.act(_join(e, p))

    def forward(self, enc, pred):
        """enc (N, T, De), pred (N, U+1, Dp) -> logits (N, T, U+1, V);
        enc (N, De), pred (N, Dp) -> (N, V)."""
        return self.fc_out(self.hidden(enc, pred), torch.float32)


class HAT(nn.Module):
    """Hybrid autoregressive transducer joiner: a Bernoulli blank gate and
    a label softmax; returns log-probs."""

    def __init__(self, odim, hdim=512, denc=512, dpred=640, generator=None):
        super().__init__()
        self.fc_enc = Dense(denc, hdim)
        self.fc_pred = Dense(dpred, hdim)
        self.fc_out = Dense(hdim, odim)
        init_weights(self, generator)

    def forward(self, enc, pred):
        f32 = torch.float32
        h = torch.tanh(_join(self.fc_enc(_f32(enc), f32),
                             self.fc_pred(_f32(pred), f32)))
        logits = self.fc_out(h, f32)
        blank = logits[..., :1]
        return torch.cat([F.logsigmoid(blank), F.logsigmoid(-blank)
                          + torch.log_softmax(logits[..., 1:], -1)], -1)

    def ilm_logp(self, pred):
        """Internal LM estimate: the label softmax with no encoder term."""
        f32 = torch.float32
        h = torch.tanh(self.fc_pred(_f32(pred), f32))
        return torch.log_softmax(self.fc_out(h, f32)[..., 1:], -1)


class LogAdd(nn.Module):
    """The 'simple' additive joiner: training inputs give the two factors
    (f, g) for `ops.rnnt_simple`; decode-step rows give log_softmax(f +
    g), already normalised."""

    def __init__(self, odim, denc=512, dpred=640, generator=None):
        super().__init__()
        self.fc_enc = Dense(denc, odim)
        self.fc_pred = Dense(dpred, odim)
        init_weights(self, generator)

    def forward(self, enc, pred):
        f32 = torch.float32
        e = self.fc_enc(_f32(enc), f32)
        p = self.fc_pred(_f32(pred), f32)
        if e.dim() <= 2:
            return torch.log_softmax(e + p, -1)
        return e, p
