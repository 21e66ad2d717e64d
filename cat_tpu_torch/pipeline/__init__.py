"""The experiment pipelines of the port: `python -m
cat_tpu_torch.pipeline.asr <expdir>` (tokenizer, pack, train, decode),
`python -m cat_tpu_torch.pipeline.lm <expdir>` (tokenizer, pack, train,
evaluate) and `python -m cat_tpu_torch.pipeline.ngram <expdir>`."""
