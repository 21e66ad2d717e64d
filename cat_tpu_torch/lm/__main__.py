"""python -m cat_tpu_torch.lm {ppl,rescore} ... (the JAX package's task
CLI)."""
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m cat_tpu_torch.lm {ppl|rescore} ...")
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "ppl":
        from cat_tpu_torch.lm.ppl import main as run
    elif cmd == "rescore":
        from cat_tpu_torch.lm.rescore import main as run
    else:
        raise SystemExit(f"unknown subcommand {cmd}")
    run(rest)


if __name__ == "__main__":
    main()
