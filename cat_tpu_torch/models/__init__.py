"""Model zoo of the port: encoders, RNN-T predictors and LMs, and joiners
registered by class name for config reflection, as `cat_tpu.models`
does. Only the classes below are ported; the others raise, the JAX
package's encoders naming the ROADMAP.md section that ports them. Every
decoder of the JAX package is ported."""
from cat_tpu_torch.models import decoders, encoders, joiner

_ENCODERS = {"ConformerNet": encoders.ConformerNet, "LSTM": encoders.LSTM,
             "TDNN_NAS": encoders.TDNN_NAS,
             "JoinAPLinearEncoder": encoders.JoinAPLinearEncoder,
             "JoinAPNonLinearEncoder": encoders.JoinAPNonLinearEncoder,
             "EmbeddingEncoder": encoders.EmbeddingEncoder}
# the JAX package's other encoders, by the ROADMAP.md section porting them
UNPORTED_ENCODERS = {
    **dict.fromkeys(("VGGLSTM", "BLSTMN", "LSTMrowCONV", "TDNN_LSTM",
                     "ConformerLSTM"), "§A.6b"),
    "Wav2Vec2Encoder": "§A.8"}
_DECODERS = {"LSTMPredictor": decoders.LSTMPredictor,
             "Embedding": decoders.Embedding,
             "CausalTransformer": decoders.CausalTransformer,
             "TransformerDecoder": decoders.TransformerDecoder,
             "SyllableEnhancedLSTM": decoders.SyllableEnhancedLSTM,
             "ZeroDecoder": decoders.ZeroDecoder}
_JOINERS = {"JointNet": joiner.JointNet, "HAT": joiner.HAT,
            "LogAdd": joiner.LogAdd}


def _get(zoo, kind, name, sections=None):
    if name not in zoo:
        section = (sections or {}).get(name)
        raise NotImplementedError(f"{kind} {name!r} is not ported to "
                                  "cat_tpu_torch yet; see ROADMAP.md"
                                  + (f" {section}" if section else ""))
    return zoo[name]


def get_encoder(name):
    return _get(_ENCODERS, "encoder", name, UNPORTED_ENCODERS)


def get_decoder(name):
    return _get(_DECODERS, "decoder", name)


def get_joiner(name):
    return _get(_JOINERS, "joiner", name)
