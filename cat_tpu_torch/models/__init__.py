"""Model zoo of the port: encoders registered by class name for config
reflection, as `cat_tpu.models` does. Only `ConformerNet` is ported."""
from cat_tpu_torch.models import encoders

_ENCODERS = {"ConformerNet": encoders.ConformerNet}


def get_encoder(name):
    if name not in _ENCODERS:
        raise NotImplementedError(f"encoder {name!r} is not ported to "
                                  "cat_tpu_torch yet; see ROADMAP.md")
    return _ENCODERS[name]
