"""RNN-Transducer training and decoding (counterpart of `cat_tpu.rnnt`)."""
