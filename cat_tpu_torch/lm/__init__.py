"""Language-model tasks of the port: n-best rescoring (`rescore`). The
neural LMs, their trainers and perplexity are ROADMAP.md §A.5."""
