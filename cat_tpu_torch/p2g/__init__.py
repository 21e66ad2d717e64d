"""LLM-P2G: seq2seq phoneme-to-grapheme with noisy-phoneme training
(counterpart of `cat_tpu/p2g`): an encoder-decoder transformer trained by
cross-entropy over noisy phoneme hypotheses (DANP) or by the loss
marginalised over K candidates (TKM/SKM), decoded greedily or by
marginalised rescoring."""
from cat_tpu_torch.p2g.train import (P2GSeq2Seq, build_model, danp_expand,
                                     greedy_generate, make_train_step,
                                     marginalized_decode,
                                     marginalized_rescore, seq_logp,
                                     tkm_loss)
