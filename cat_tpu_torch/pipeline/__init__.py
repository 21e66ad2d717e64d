"""The experiment pipeline of the port: `python -m
cat_tpu_torch.pipeline.asr <expdir>` (tokenizer, pack, train, decode)."""
