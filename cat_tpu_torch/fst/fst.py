"""Weighted FSTs on the host (counterpart of `cat_tpu/fst/fst.py`).

A small WFST library in the log-probability semiring (weights are
natural-log probabilities; a path's weight is their sum, a set's their
logsumexp): composition with the epsilon-sequencing filter, epsilon
removal, trimming, determinization with input-epsilon removal and
encoded minimization, and IO (OpenFST text and binary, and an npz layout
shared with the JAX package, so a graph cached by either loads in the
other). OpenFST's tropical weights are the negation of these.

Every algorithm iterates and sums in the JAX package's order, so both
build the same graphs arc for arc.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG_INF = -1e30
EPS = 0  # epsilon label id (OpenFST convention)


def logaddexp(a, b):
    if a <= NEG_INF / 2:
        return b
    if b <= NEG_INF / 2:
        return a
    m = max(a, b)
    return m + np.log(np.exp(a - m) + np.exp(b - m))


@dataclass
class Fst:
    """Mutable WFST. Arcs: (src, dst, ilabel, olabel) int32 + weight f64."""

    num_states: int = 0
    start: int = -1
    arcs: list = field(default_factory=list)  # (src, dst, il, ol, w)
    finals: dict = field(default_factory=dict)  # state -> log-prob weight

    def add_state(self) -> int:
        self.num_states += 1
        return self.num_states - 1

    def add_arc(self, src, dst, ilabel, olabel, weight=0.0):
        self.arcs.append((src, dst, ilabel, olabel, float(weight)))

    def set_final(self, state, weight=0.0):
        self.finals[state] = float(weight)

    @property
    def num_arcs(self):
        return len(self.arcs)

    def arcs_by_state(self):
        out = [[] for _ in range(self.num_states)]
        for a in self.arcs:
            out[a[0]].append(a)
        return out

    def arrays(self):
        """Dense numpy views: (src, dst, il, ol) int32 (A,4), w f32 (A,)."""
        if not self.arcs:
            return (np.zeros((0, 4), np.int32), np.zeros((0,), np.float32))
        arr = np.asarray([(a[0], a[1], a[2], a[3]) for a in self.arcs],
                         np.int32)
        w = np.asarray([a[4] for a in self.arcs], np.float32)
        return arr, w

    def final_array(self):
        f = np.full((self.num_states,), NEG_INF, np.float32)
        for s, w in self.finals.items():
            f[s] = w
        return f

    # ---------------- serialization ----------------

    def write_text(self, fileobj):
        """OpenFST-style text format, weights written as -logprob
        (tropical convention) for interop with fstcompile."""
        close = False
        if isinstance(fileobj, str):
            fileobj = open(fileobj, "w")
            close = True
        for src, dst, il, ol, w in self.arcs:
            fileobj.write(f"{src}\t{dst}\t{il}\t{ol}\t{-w:.6f}\n")
        for s, w in sorted(self.finals.items()):
            fileobj.write(f"{s}\t{-w:.6f}\n")
        if close:
            fileobj.close()

    @classmethod
    def read_text(cls, fileobj, negate_weights=True):
        """Read OpenFST text format. Tropical weights are negated into
        log-probs by default."""
        close = False
        if isinstance(fileobj, str):
            fileobj = open(fileobj)
            close = True
        fst = cls()
        max_state = -1
        for line in fileobj:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                src, dst, il, ol = map(int, parts[:4])
                w = float(parts[4]) if len(parts) > 4 else 0.0
                if negate_weights:
                    w = -w
                fst.arcs.append((src, dst, il, ol, w))
                max_state = max(max_state, src, dst)
                if fst.start < 0:
                    fst.start = src
            else:
                s = int(parts[0])
                w = float(parts[1]) if len(parts) > 1 else 0.0
                if negate_weights:
                    w = -w
                fst.finals[s] = w
                max_state = max(max_state, s)
        fst.num_states = max_state + 1
        if close:
            fileobj.close()
        return fst

    @classmethod
    def read_openfst(cls, path, negate_weights=True):
        """Read an OpenFST binary StdVectorFst (the on-disk format of
        den_lm.fst etc.): tropical (-log) weights are negated into
        log-probs, a +inf final weight means non-final. Only
        vector/standard (const also works: the same arc layout after the
        header) little-endian files."""
        import struct

        with open(path, "rb") as f:
            data = f.read()
        off = 0

        def u32():
            nonlocal off
            (v,) = struct.unpack_from("<i", data, off)
            off += 4
            return v

        def u64():
            nonlocal off
            (v,) = struct.unpack_from("<q", data, off)
            off += 8
            return v

        def f32():
            nonlocal off
            (v,) = struct.unpack_from("<f", data, off)
            off += 4
            return v

        magic = u32()
        if magic != 2125659606:
            raise ValueError(f"not an OpenFST binary file: magic={magic}")
        fsttype = data[off + 4: off + 4 + u32()].decode()
        off += len(fsttype)
        arctype = data[off + 4: off + 4 + u32()].decode()
        off += len(arctype)
        if fsttype not in ("vector", "const") or arctype != "standard":
            raise ValueError(f"unsupported fst/arc type: "
                             f"{fsttype}/{arctype}")
        u32()  # version
        u32()  # flags
        u64()  # properties
        start = u64()
        num_states = u64()
        u64()  # numarcs (unused; -1 in some versions)

        fst = cls(num_states=int(num_states), start=int(start))
        sgn = -1.0 if negate_weights else 1.0
        for s in range(num_states):
            w = f32()
            if w != float("inf"):
                fst.finals[s] = sgn * w
            narcs = u64()
            for _ in range(narcs):
                il = u32()
                ol = u32()
                aw = f32()
                dst = u32()
                fst.arcs.append((s, dst, il, ol, sgn * aw))
        if off != len(data):
            raise ValueError(f"trailing bytes: read {off} of {len(data)}")
        return fst

    def save(self, path):
        arr, w = self.arrays()
        np.savez(path, arcs=arr, weights=w, start=np.int32(self.start),
                 num_states=np.int32(self.num_states),
                 final_states=np.asarray(sorted(self.finals), np.int32),
                 final_weights=np.asarray(
                     [self.finals[s] for s in sorted(self.finals)],
                     np.float32))

    @classmethod
    def load(cls, path):
        z = np.load(path)
        fst = cls(num_states=int(z["num_states"]), start=int(z["start"]))
        arr, w = z["arcs"], z["weights"]
        fst.arcs = [(int(a[0]), int(a[1]), int(a[2]), int(a[3]), float(x))
                    for a, x in zip(arr, w)]
        fst.finals = {int(s): float(x) for s, x in
                      zip(z["final_states"], z["final_weights"])}
        return fst


def connect(fst: Fst) -> Fst:
    """Trim states not both accessible from start and co-accessible."""
    fwd = [[] for _ in range(fst.num_states)]
    bwd = [[] for _ in range(fst.num_states)]
    for src, dst, *_ in fst.arcs:
        fwd[src].append(dst)
        bwd[dst].append(src)

    def reach(starts, adj):
        seen = set(starts)
        stack = list(starts)
        while stack:
            s = stack.pop()
            for d in adj[s]:
                if d not in seen:
                    seen.add(d)
                    stack.append(d)
        return seen

    if fst.start < 0:
        return Fst()
    acc = reach([fst.start], fwd)
    coacc = reach([s for s in fst.finals if s in acc], bwd)
    keep = acc & coacc
    remap = {}
    out = Fst()
    for s in sorted(keep):
        remap[s] = out.add_state()
    if fst.start not in remap:
        return Fst()
    out.start = remap[fst.start]
    for src, dst, il, ol, w in fst.arcs:
        if src in remap and dst in remap:
            out.add_arc(remap[src], remap[dst], il, ol, w)
    for s, w in fst.finals.items():
        if s in remap:
            out.set_final(remap[s], w)
    return out


def compose(fst1: Fst, fst2: Fst) -> Fst:
    """Compose with the epsilon-sequencing filter (3 filter states), so
    epsilon interleavings are not double-counted — essential in the
    probability semiring (the denominator mass must be exact)."""
    out = Fst()
    arcs2_by_state: list[dict] = [dict() for _ in range(fst2.num_states)]
    eps2_by_state: list[list] = [[] for _ in range(fst2.num_states)]
    for a in fst2.arcs:
        src, dst, il, ol, w = a
        if il == EPS:
            eps2_by_state[src].append(a)
        else:
            arcs2_by_state[src].setdefault(il, []).append(a)
    arcs1_by_state = [[] for _ in range(fst1.num_states)]
    for a in fst1.arcs:
        arcs1_by_state[a[0]].append(a)

    state_map = {}

    def get_state(q1, q2, f):
        key = (q1, q2, f)
        if key not in state_map:
            state_map[key] = out.add_state()
            queue.append(key)
        return state_map[key]

    queue = []
    out.start = get_state(fst1.start, fst2.start, 0)
    qi = 0
    while qi < len(queue):
        q1, q2, f = queue[qi]
        sid = state_map[(q1, q2, f)]
        qi += 1
        # final weight
        if q1 in fst1.finals and q2 in fst2.finals:
            out.set_final(sid, fst1.finals[q1] + fst2.finals[q2])
        # Mohri's epsilon-sequencing filter:
        #   f=0: match, eps1-alone (->1), eps2-alone (->2), both (->0)
        #   f=1: match (->0), eps1-alone (->1)
        #   f=2: match (->0), eps2-alone (->2)
        for src1, dst1, il1, ol1, w1 in arcs1_by_state[q1]:
            if ol1 == EPS:
                # eps1-alone: advance fst1 only.
                if f != 2:
                    out.add_arc(sid, get_state(dst1, q2, 1), il1, EPS, w1)
                # simultaneous eps1+eps2 (only from filter state 0).
                if f == 0:
                    for _, dst2, _, ol2, w2 in eps2_by_state[q2]:
                        out.add_arc(sid, get_state(dst1, dst2, 0), il1,
                                    ol2, w1 + w2)
                continue
            for src2, dst2, il2, ol2, w2 in arcs2_by_state[q2].get(ol1, []):
                out.add_arc(sid, get_state(dst1, dst2, 0), il1, ol2, w1 + w2)
        # eps2-alone: advance fst2 only.
        if f != 1:
            for src2, dst2, il2, ol2, w2 in eps2_by_state[q2]:
                out.add_arc(sid, get_state(q1, dst2, 2), EPS, ol2, w2)
    return connect(out)


def rm_epsilon(fst: Fst) -> Fst:
    """Remove input-epsilon arcs (weight-correct, requires an acyclic
    epsilon subgraph — true for backoff-LM compositions where epsilon
    arcs only move to lower n-gram orders)."""
    eps_adj = [[] for _ in range(fst.num_states)]
    for src, dst, il, ol, w in fst.arcs:
        if il == EPS:
            eps_adj[src].append((dst, w))

    # epsilon closure with logsumexp-combined weights, memoized DFS
    closure_cache: dict[int, dict[int, float]] = {}
    visiting = set()

    def closure(s) -> dict[int, float]:
        if s in closure_cache:
            return closure_cache[s]
        if s in visiting:
            raise ValueError("epsilon cycle detected; rm_epsilon requires "
                             "an acyclic epsilon subgraph")
        visiting.add(s)
        res = {s: 0.0}
        for dst, w in eps_adj[s]:
            for r, rw in closure(dst).items():
                tot = w + rw
                res[r] = logaddexp(res.get(r, NEG_INF), tot)
        visiting.discard(s)
        closure_cache[s] = res
        return res

    out = Fst(num_states=fst.num_states, start=fst.start)
    non_eps_by_state = [[] for _ in range(fst.num_states)]
    for a in fst.arcs:
        if a[2] != EPS:
            non_eps_by_state[a[0]].append(a)
    for s in range(fst.num_states):
        cl = closure(s)
        fin = NEG_INF
        for r, cw in cl.items():
            for _, dst, il, ol, w in non_eps_by_state[r]:
                out.add_arc(s, dst, il, ol, cw + w)
            if r in fst.finals:
                fin = logaddexp(fin, cw + fst.finals[r])
        if fin > NEG_INF / 2:
            out.set_final(s, fin)
    return connect(out)


def determinize_star(fst: Fst, max_states: int = 1_000_000,
                     wquant: float = 1e-6) -> Fst:
    """Weighted transducer determinization with input-ε removal.

    The role of Kaldi's `fstdeterminizestar` in a TLG build: subset
    construction over (state, residual weight, residual output string)
    triples in the max/tropical semiring (decode-time Viterbi
    semantics), where input-ε arcs are folded into the closure instead
    of being emitted.
    Output strings longer than one label are factored into chains of
    input-ε arcs (Kaldi does the same). Requires a determinizable input
    (true for disambiguated L∘G); guarded by `max_states`.
    """
    q = lambda w: round(w / wquant) * wquant

    def closure(elems):
        """ε-input closure keeping the best weight per (state, out)."""
        best = {}
        stack = list(elems)
        for s, w, o in stack:
            k = (s, o)
            if k not in best or w > best[k]:
                best[k] = w
        while stack:
            s, w, o = stack.pop()
            if best.get((s, o), NEG_INF) > w:
                continue
            for src, dst, il, ol, aw in by_src[s]:
                if il != EPS:
                    continue
                no = o + ((ol,) if ol != EPS else ())
                nw = w + aw
                k = (dst, no)
                if nw > best.get(k, NEG_INF) + wquant / 2:
                    best[k] = nw
                    stack.append((dst, nw, no))
        return tuple(sorted((s, q(w), o) for (s, o), w in best.items()))

    def normalize(elems):
        """Pull out the max weight and the longest common output
        prefix; return (key, w, prefix)."""
        wmax = max(w for _, w, _ in elems)
        outs = [o for _, _, o in elems]
        prefix = outs[0]
        for o in outs[1:]:
            n = 0
            while n < len(prefix) and n < len(o) and prefix[n] == o[n]:
                n += 1
            prefix = prefix[:n]
        key = tuple(sorted((s, q(w - wmax), o[len(prefix):])
                           for s, w, o in elems))
        return key, wmax, prefix

    by_src = [[] for _ in range(fst.num_states)]
    for a in fst.arcs:
        by_src[a[0]].append(a)

    out = Fst()
    init = closure([(fst.start, 0.0, ())])
    key0, w0, pre0 = normalize(init)
    # initial residual prefix/weight folded into a chain from a new start
    subsets = {key0: out.add_state()}
    out.start = subsets[key0]
    if pre0 or abs(w0) > 0:
        # residual initial weight/outputs ride an ε-input chain from a
        # fresh start state, weight on the first arc
        s0 = out.add_state()
        prev, first = s0, True
        for ol in pre0[:-1]:
            nxt = out.add_state()
            out.add_arc(prev, nxt, EPS, ol, w0 if first else 0.0)
            prev, first = nxt, False
        out.add_arc(prev, subsets[key0], EPS,
                    pre0[-1] if pre0 else EPS, w0 if first else 0.0)
        out.start = s0
    work = [key0]
    keyof = {subsets[key0]: key0}

    def emit_chain(src_state, dst_state, ilabel, outs, w):
        """Arc with output string `outs` factored via ε-input chain."""
        if len(outs) <= 1:
            out.add_arc(src_state, dst_state, ilabel,
                        outs[0] if outs else EPS, w)
            return
        prev = src_state
        for i, ol in enumerate(outs[:-1]):
            nxt = out.add_state()
            out.add_arc(prev, nxt, ilabel if i == 0 else EPS, ol,
                        w if i == 0 else 0.0)
            prev = nxt
        out.add_arc(prev, dst_state, EPS, outs[-1], 0.0)

    while work:
        key = work.pop()
        sid = subsets[key]
        # final weight: best over final elements; residual outputs of
        # final elements become ε-input chains into a fresh final state
        for s, w, o in key:
            if s in fst.finals:
                fw = w + fst.finals[s]
                if not o:
                    cur = out.finals.get(sid, NEG_INF)
                    out.finals[sid] = max(cur, fw)
                else:
                    fin = out.add_state()
                    out.set_final(fin, 0.0)
                    emit_chain(sid, fin, EPS, o, fw)
        # group outgoing non-ε-input transitions by input label
        trans = {}
        for s, w, o in key:
            for src, dst, il, ol, aw in by_src[s]:
                if il == EPS:
                    continue
                no = o + ((ol,) if ol != EPS else ())
                trans.setdefault(il, []).append((dst, w + aw, no))
        for il, elems in sorted(trans.items()):
            cl = closure(elems)
            nkey, w, prefix = normalize(cl)
            if nkey not in subsets:
                if len(subsets) >= max_states:
                    raise RuntimeError(
                        "determinize_star: state budget exceeded "
                        "(input may not be determinizable)")
                subsets[nkey] = out.add_state()
                work.append(nkey)
            emit_chain(sid, subsets[nkey], il, prefix, w)
    return out


def minimize_encoded(fst: Fst, wquant: float = 1e-6) -> Fst:
    """Minimization treating (ilabel, olabel, weight) as an encoded
    label, the role of Kaldi's `fstminimizeencoded`: plain acceptor
    partition refinement, no weight pushing, so it is safe on any
    deterministic machine and merges exactly the states with identical
    suffix languages under the encoding."""
    q = lambda w: round(w / wquant)
    n = fst.num_states
    by_src = [[] for _ in range(n)]
    for src, dst, il, ol, w in fst.arcs:
        by_src[src].append((il, ol, q(w), dst))

    # initial partition by final weight
    cls = [0] * n
    sig2cls = {}
    for s in range(n):
        sig = q(fst.finals[s]) if s in fst.finals else None
        cls[s] = sig2cls.setdefault(sig, len(sig2cls))
    while True:
        sig2new = {}
        new_cls = [0] * n
        for s in range(n):
            sig = (cls[s], tuple(sorted(
                (il, ol, w, cls[d]) for il, ol, w, d in by_src[s])))
            new_cls[s] = sig2new.setdefault(sig, len(sig2new))
        if len(sig2new) == len(set(cls)):
            break
        cls = new_cls

    out = Fst()
    rep = {}
    for s in range(n):
        if cls[s] not in rep:
            rep[cls[s]] = out.add_state()
    out.start = rep[cls[fst.start]]
    seen = set()
    for src, dst, il, ol, w in fst.arcs:
        a = (rep[cls[src]], rep[cls[dst]], il, ol, q(w))
        if a in seen:
            continue
        seen.add(a)
        out.add_arc(rep[cls[src]], rep[cls[dst]], il, ol, w)
    for s, w in fst.finals.items():
        out.finals[rep[cls[s]]] = w
    return out
