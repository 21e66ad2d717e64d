"""Port parity for n-best rescoring: `cat_tpu_torch.lm.rescore` against
`cat_tpu.lm.rescore` on the CPU, on seeded n-best lists of text and of
token ids.

- `ngram_nll` equal to JAX's (the same float), `rescore_nbest` the same
  (score, hypothesis) for every utterance at several α, β;
  `search_lm_weight` the same WER, α and β.
- The CLI (`main`) on an n-best pickle and an ARPA file, plain and
  `.gz`, with `--search`: the same rescored text and printed records as
  JAX's. A neural LM (an LM expdir) is held to JAX's in
  `tests/test_torch_lm_pipeline.py`.
"""
import json
import pickle

import numpy as np
import pytest

from cat_tpu.fst import ngram as jng
from cat_tpu.lm import rescore as jrs
from cat_tpu_torch.fst import ngram as png
from cat_tpu_torch.lm import rescore as prs

WORDS = ["yes", "no", "maybe", "so"]


def nbest_lists(seed, text=True, utts=12, k=5):
    rng = np.random.default_rng(seed)
    nbest, refs = {}, {}
    for u in range(utts):
        uid = f"u{u:02d}"
        ref = [WORDS[int(i)] for i in rng.integers(0, 4, int(rng.integers(1, 5)))]
        refs[uid] = " ".join(ref)
        hyps = {}
        for b in range(k):
            h = list(ref)
            for _ in range(int(rng.integers(0, 3))):
                pos = int(rng.integers(0, len(h) + 1))
                h.insert(pos, WORDS[int(rng.integers(0, 4))])
            am = float(-rng.uniform(0, 8))
            hyps[b] = (am, " ".join(h) if text else
                       [WORDS.index(w) + 1 for w in h])
        nbest[uid] = hyps
    return nbest, refs


def train_lms(order, text=True):
    rng = np.random.default_rng(order)
    sents = [[WORDS[int(i)] for i in rng.integers(0, 4, int(rng.integers(1, 6)))]
             for _ in range(50)]
    if not text:
        sents = [[WORDS.index(w) + 1 for w in s] for s in sents]
    return jng.train_ngram(sents, order), png.train_ngram(sents, order)


@pytest.mark.parametrize("text", [True, False])
@pytest.mark.parametrize("order", [2, 3])
def test_rescoring_matches_jax(text, order):
    nbest, refs = nbest_lists(order, text)
    jlm, plm = train_lms(order, text)
    want = jrs.ngram_nll(jlm, nbest)
    got = prs.ngram_nll(plm, nbest)
    assert got == want
    for alpha, beta in ((0.0, 0.0), (0.5, 0.0), (1.0, 1.5), (0.3, -0.7)):
        assert prs.rescore_nbest(nbest, got, alpha, beta) == \
            jrs.rescore_nbest(nbest, want, alpha, beta)


@pytest.mark.parametrize("text", [True, False])
def test_search_lm_weight_matches_jax(text):
    nbest, refs = nbest_lists(5, text)
    jlm, plm = train_lms(3, text)
    kw = dict(alphas=[0.0, 0.25, 0.5, 1.0, 2.0], betas=[-1.0, 0.0, 1.0])
    if not text:
        class Tok:
            def decode(self, ids):
                return " ".join(WORDS[i - 1] for i in ids)
        kw["tokenizer"] = Tok()
    got = prs.search_lm_weight(nbest, prs.ngram_nll(plm, nbest), refs, **kw)
    want = jrs.search_lm_weight(nbest, jrs.ngram_nll(jlm, nbest), refs, **kw)
    assert got == want
    # characters too
    kw["char_level"] = True
    assert prs.search_lm_weight(nbest, prs.ngram_nll(plm, nbest), refs,
                                **kw) == \
        jrs.search_lm_weight(nbest, jrs.ngram_nll(jlm, nbest), refs, **kw)


@pytest.mark.parametrize("suffix,search", [(".arpa", False),
                                           (".arpa.gz", True)])
def test_cli_matches_jax(tmp_path, capsys, suffix, search):
    nbest, refs = nbest_lists(9)
    jlm, _ = train_lms(3)
    nb_path = tmp_path / "nbest.pkl"
    with open(nb_path, "wb") as f:
        pickle.dump(nbest, f)
    arpa = str(tmp_path / f"lm{suffix}")
    jng.write_arpa(jlm, arpa)
    ref = tmp_path / "ref.txt"
    ref.write_text("".join(f"{u}\t{t}\n" for u, t in refs.items()))
    printed = []
    for mod, name in ((jrs, "jax"), (prs, "port")):
        args = [str(nb_path), arpa, "--alpha", "0.4", "--beta", "0.2",
                "--ref", str(ref), "--output", str(tmp_path / f"{name}.txt")]
        mod.main(args + (["--search"] if search else []))
        printed.append([json.loads(line) for line in
                        capsys.readouterr().out.splitlines()])
    assert printed[1] == printed[0] and printed[1]
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()

