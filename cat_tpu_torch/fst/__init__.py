"""WFST subsystem of the port (counterpart of `cat_tpu/fst/`), on the
host in numpy: n-gram LMs and ARPA IO, weighted FSTs, the graph builders
(CTC topology, G, L, the CTC-CRF denominator graph), TLG decoding with
its C++ core, and joint-sequence G2P.

Weight convention: natural-log probabilities (added along a path,
logsumexp across paths). OpenFST tropical weights are the negation of
this.
"""

from cat_tpu_torch.fst.fst import Fst, compose, connect, rm_epsilon
from cat_tpu_torch.fst.graph import (
    DenGraph,
    arpa_to_fst,
    build_den_fst,
    ctc_topo,
    lexicon_fst,
)
from cat_tpu_torch.fst.ngram import NGramLM, read_arpa, train_ngram, write_arpa
