"""The multichannel front end (counterpart of `cat_tpu/front`): STFT,
(DNN-)WPE dereverberation, mask-based MVDR, MPDR, GEV and WPD
beamforming, log-mel."""
from cat_tpu_torch.front.beamformer import (BeamformerNet, ChannelSelector,
                                            LogMel, MaskNet, NeuralFilter,
                                            Stft, gev_weights, mvdr_weights,
                                            wpd_beamform)
from cat_tpu_torch.front.wpe import DnnWpe

__all__ = ["BeamformerNet", "ChannelSelector", "DnnWpe", "LogMel", "MaskNet",
           "NeuralFilter", "Stft", "gev_weights", "mvdr_weights",
           "wpd_beamform"]
