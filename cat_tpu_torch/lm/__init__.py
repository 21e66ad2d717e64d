"""Language-model tasks of the port: the neural LMs' trainer
(`train`), the TRF LMs (`trf`, `train_trf`), the fusion scorer
(`scorer`), perplexity (`ppl`) and n-best rescoring (`rescore`);
`python -m cat_tpu_torch.lm {ppl,rescore}`."""
