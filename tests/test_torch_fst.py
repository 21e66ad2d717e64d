"""Port parity for the WFST library and graph builders:
`cat_tpu_torch.fst.{fst,graph}` against `cat_tpu.fst.{fst,graph}` on
the CPU, on seeded random inputs built alike in both packages.

Each operation (`connect`, `compose`, `rm_epsilon`, `determinize_star`,
`minimize_encoded`, `ctc_topo`, `arpa_to_fst`, `lexicon_fst`,
`build_den_fst`) gives the same start state, the same arc list in the
same order (states and labels equal, weights within 1e-6) and the same
final weights (within 1e-6) as JAX's. Files cross packages: OpenFST text,
OpenFST binary (`read_openfst`), the npz layout of `Fst.save`, and
`DenGraph.save`.
"""
import struct

import numpy as np
import pytest

from cat_tpu.fst import fst as jfst
from cat_tpu.fst import graph as jgraph
from cat_tpu.fst import ngram as jng
from cat_tpu_torch.fst import fst as pfst
from cat_tpu_torch.fst import graph as pgraph
from cat_tpu_torch.fst import ngram as png

W_TOL = 1e-6


def assert_same_fst(got, want):
    assert got.num_states == want.num_states
    assert got.start == want.start
    assert len(got.arcs) == len(want.arcs)
    ga = np.asarray([a[:4] for a in got.arcs], np.int64).reshape(-1, 4)
    wa = np.asarray([a[:4] for a in want.arcs], np.int64).reshape(-1, 4)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose([a[4] for a in got.arcs],
                               [a[4] for a in want.arcs], rtol=0, atol=W_TOL)
    assert got.finals.keys() == want.finals.keys()
    for s, w in want.finals.items():
        assert abs(got.finals[s] - w) <= W_TOL


def random_fst(mod, seed, states=7, arcs=16, labels=4, eps=0.25,
               acyclic_eps=True):
    """A seeded random transducer of `mod`'s Fst: input-epsilon arcs only
    from lower to higher states (an acyclic epsilon subgraph)."""
    rng = np.random.default_rng(seed)
    f = mod.Fst()
    for _ in range(states):
        f.add_state()
    f.start = 0
    for _ in range(arcs):
        src, dst = (int(x) for x in rng.integers(0, states, 2))
        il = 0 if rng.random() < eps else int(rng.integers(1, labels + 1))
        ol = 0 if rng.random() < eps else int(rng.integers(1, labels + 1))
        if il == 0 and acyclic_eps:
            src, dst = min(src, dst), max(src, dst)
            if src == dst:
                dst = min(dst + 1, states - 1)
                if src == dst:
                    continue
        f.add_arc(src, dst, il, ol, float(np.log(rng.uniform(0.05, 1.0))))
    for s in rng.choice(states, 2, replace=False):
        f.set_final(int(s), float(np.log(rng.uniform(0.2, 1.0))))
    return f


def lexicon_and_lm(seed, words=8, phones=5, order=2):
    """A seeded lexicon of prefix-free pronunciations (5 words of 2 phones,
    3 of 3; so L ∘ G determinizes) and a word n-gram's corpus."""
    rng = np.random.default_rng(seed)
    names = [f"w{i}" for i in range(words)]
    pairs = [(a, b) for a in range(phones) for b in range(phones)]
    order2 = rng.permutation(len(pairs))
    short = [pairs[i] for i in order2[:5]]
    free = [pairs[i] for i in order2[5:]]
    long = [free[i] + (int(rng.integers(0, phones)),) for i in range(3)]
    lexicon = [(w, [f"p{p}" for p in pron])
               for w, pron in zip(names, short + long)]
    corpus = [[names[int(i)] for i in
               rng.integers(0, words, int(rng.integers(1, 6)))]
              for _ in range(30)]
    word2id = {w: i + 1 for i, w in enumerate(names)}
    phone2id = {f"p{i}": i + 1 for i in range(phones)}
    return lexicon, corpus, word2id, phone2id


@pytest.mark.parametrize("seed", range(4))
def test_connect_compose_rm_epsilon_match_jax(seed):
    a = [random_fst(m, seed) for m in (jfst, pfst)]
    b = [random_fst(m, 100 + seed) for m in (jfst, pfst)]
    assert_same_fst(pfst.connect(a[1]), jfst.connect(a[0]))
    want = jfst.compose(a[0], b[0])
    assert_same_fst(pfst.compose(a[1], b[1]), want)
    assert_same_fst(pfst.rm_epsilon(a[1]), jfst.rm_epsilon(a[0]))
    if want.num_states:
        assert_same_fst(pfst.rm_epsilon(pfst.compose(a[1], b[1])),
                        jfst.rm_epsilon(want))


def test_rm_epsilon_refuses_an_epsilon_cycle():
    f = pfst.Fst(num_states=2, start=0)
    f.add_arc(0, 1, 0, 0, -0.1)
    f.add_arc(1, 0, 0, 0, -0.1)
    f.set_final(1)
    with pytest.raises(ValueError, match="epsilon cycle"):
        pfst.rm_epsilon(f)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("order", [2, 3])
def test_determinize_and_minimize_lg_match_jax(seed, order):
    """L ∘ G of a seeded lexicon and word n-gram, determinized and
    minimized, as `build_tlg` does."""
    lexicon, corpus, word2id, phone2id = lexicon_and_lm(seed)
    out = []
    for mod_fst, mod_graph, mod_ng in ((jfst, jgraph, jng),
                                       (pfst, pgraph, png)):
        G = mod_graph.arpa_to_fst(mod_ng.train_ngram(corpus, order),
                                  sym2id=word2id)
        L = mod_graph.lexicon_fst(lexicon, word2id, phone2id)
        LG = mod_fst.connect(mod_fst.compose(L, G))
        det = mod_fst.determinize_star(LG)
        out.append((G, L, LG, det, mod_fst.minimize_encoded(det)))
    for got, want in zip(out[1], out[0]):
        assert_same_fst(got, want)
    assert out[1][4].num_states <= out[1][3].num_states


@pytest.mark.parametrize("seed", range(3))
def test_determinize_random_acceptor_matches_jax(seed):
    """Random transducers with input-epsilon arcs (acyclic), as far as
    they determinize within a small state budget."""
    a = [random_fst(m, 200 + seed, eps=0.2) for m in (jfst, pfst)]
    try:
        want = jfst.determinize_star(a[0], max_states=200)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="state budget"):
            pfst.determinize_star(a[1], max_states=200)
        return
    got = pfst.determinize_star(a[1], max_states=200)
    assert_same_fst(got, want)
    assert_same_fst(pfst.minimize_encoded(got), jfst.minimize_encoded(want))


@pytest.mark.parametrize("num_classes", [2, 5])
def test_ctc_topo_and_den_fst_match_jax(num_classes):
    assert_same_fst(pgraph.ctc_topo(num_classes),
                    jgraph.ctc_topo(num_classes))
    rng = np.random.default_rng(num_classes)
    seqs = [[int(x) for x in rng.integers(1, num_classes,
                                          int(rng.integers(1, 8)))]
            for _ in range(40)]
    for order in (1, 2, 3):
        want = jgraph.build_den_fst(jng.train_ngram(seqs, order),
                                    num_classes)
        got = pgraph.build_den_fst(png.train_ngram(seqs, order),
                                   num_classes)
        assert_same_fst(got, want)
        assert_same_fst(pgraph.arpa_to_fst(png.train_ngram(seqs, order)),
                        jgraph.arpa_to_fst(jng.train_ngram(seqs, order)))
        jd, pd = jgraph.DenGraph.from_fst(want), pgraph.DenGraph.from_fst(got)
        for k in ("arc_src", "arc_dst", "arc_label", "arc_weight",
                  "start_weights", "final_weights"):
            np.testing.assert_array_equal(getattr(pd, k), getattr(jd, k))
        assert pd.num_states == jd.num_states


def test_lexicon_fst_with_silence_matches_jax():
    lexicon, _, word2id, phone2id = lexicon_and_lm(7)
    phone2id["sil"] = len(phone2id) + 1
    assert_same_fst(
        pgraph.lexicon_fst(lexicon, word2id, phone2id, "sil", 0.3),
        jgraph.lexicon_fst(lexicon, word2id, phone2id, "sil", 0.3))


def test_den_graph_refuses_epsilon_arcs():
    with pytest.raises(ValueError, match="epsilon-free"):
        pgraph.DenGraph.from_fst(pgraph.ctc_topo(3).__class__(
            num_states=1, start=0, arcs=[(0, 0, 0, 0, 0.0)]))


@pytest.mark.parametrize("writer,reader", [(jfst, pfst), (pfst, jfst)])
def test_fst_files_cross_packages(tmp_path, writer, reader):
    f = random_fst(writer, 5)
    txt, npz = str(tmp_path / "f.txt"), str(tmp_path / "f.npz")
    f.write_text(txt)
    f.save(npz)
    # text holds weights to 6 decimals
    assert_same_fst(reader.Fst.read_text(txt), writer.Fst.read_text(txt))
    back = reader.Fst.load(npz)
    want = writer.Fst.load(npz)
    assert_same_fst(back, want)
    np.testing.assert_allclose([a[4] for a in back.arcs],
                               [a[4] for a in f.arcs], atol=1e-6)
    den = writer.__name__.replace(".fst", ".graph")
    g_w = (jgraph if den.startswith("cat_tpu.") else pgraph).DenGraph
    g_r = (pgraph if g_w is jgraph.DenGraph else jgraph).DenGraph
    dg = g_w.from_fst(writer.rm_epsilon(random_fst(writer, 6)))
    dg.save(str(tmp_path / "den.npz"))
    again = g_r.load(str(tmp_path / "den.npz"))
    for k in ("arc_src", "arc_dst", "arc_label", "arc_weight",
              "start_weights", "final_weights"):
        np.testing.assert_array_equal(getattr(again, k), getattr(dg, k))


def _openfst_bytes(f):
    """An OpenFST binary StdVectorFst of `f` (tropical weights: -logp)."""
    def s(x):
        return struct.pack("<i", len(x)) + x.encode()
    out = struct.pack("<i", 2125659606) + s("vector") + s("standard")
    out += struct.pack("<iiqqqq", 2, 0, 0, f.start, f.num_states, -1)
    by_src = [[] for _ in range(f.num_states)]
    for a in f.arcs:
        by_src[a[0]].append(a)
    for st in range(f.num_states):
        out += struct.pack("<f", -f.finals[st] if st in f.finals
                           else float("inf"))
        out += struct.pack("<q", len(by_src[st]))
        for _, dst, il, ol, w in by_src[st]:
            out += struct.pack("<iifi", il, ol, -w, dst)
    return out


def test_read_openfst_matches_jax(tmp_path):
    path = tmp_path / "den.fst"
    path.write_bytes(_openfst_bytes(random_fst(jfst, 9)))
    got = pfst.Fst.read_openfst(str(path))
    assert_same_fst(got, jfst.Fst.read_openfst(str(path)))
    (tmp_path / "bad.fst").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="not an OpenFST"):
        pfst.Fst.read_openfst(str(tmp_path / "bad.fst"))
