"""Model zoo of the port: encoders, RNN-T predictors and joiners
registered by class name for config reflection, as `cat_tpu.models`
does. Only the classes below are ported; the others raise."""
from cat_tpu_torch.models import decoders, encoders, joiner

_ENCODERS = {"ConformerNet": encoders.ConformerNet, "LSTM": encoders.LSTM}
_DECODERS = {"LSTMPredictor": decoders.LSTMPredictor,
             "Embedding": decoders.Embedding,
             "ZeroDecoder": decoders.ZeroDecoder}
_JOINERS = {"JointNet": joiner.JointNet, "HAT": joiner.HAT,
            "LogAdd": joiner.LogAdd}


def _get(zoo, kind, name):
    if name not in zoo:
        raise NotImplementedError(f"{kind} {name!r} is not ported to "
                                  "cat_tpu_torch yet; see ROADMAP.md")
    return zoo[name]


def get_encoder(name):
    return _get(_ENCODERS, "encoder", name)


def get_decoder(name):
    return _get(_DECODERS, "decoder", name)


def get_joiner(name):
    return _get(_JOINERS, "joiner", name)
