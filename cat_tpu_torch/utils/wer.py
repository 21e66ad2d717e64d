"""WER / CER and the oracle WER over n-best lists (a copy of
`cat_tpu/utils/wer.py`, kept in the port so that it imports nothing of
the JAX package): a native edit distance with its substitution,
insertion and deletion counts, and the sentence error rate."""
from __future__ import annotations

import numpy as np


def edit_distance(ref, hyp):
    """Levenshtein distance + (sub, ins, del) counts."""
    m, n = len(ref), len(hyp)
    # dp[i][j]: (cost, subs, ins, dels)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j - 1] + cost,
                           dp[i - 1, j] + 1,
                           dp[i, j - 1] + 1)
    # backtrace for counts
    i, j = m, n
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and dp[i, j] == dp[i - 1, j - 1]
                and ref[i - 1] == hyp[j - 1]):
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(dp[m, n]), subs, ins, dels


def wer(refs, hyps, char_level=False):
    """Corpus WER (or CER). refs/hyps: dict uid→str or parallel lists.

    Returns dict with wer, errors, sub/ins/del, num_words, ser."""
    if isinstance(refs, dict):
        uids = sorted(refs)
        ref_list = [refs[u] for u in uids]
        hyp_list = [hyps.get(u, "") for u in uids]
    else:
        ref_list, hyp_list = list(refs), list(hyps)
    tot_err = tot_sub = tot_ins = tot_del = tot_words = 0
    sent_err = 0
    for r, h in zip(ref_list, hyp_list):
        r_toks = list(r.replace(" ", "")) if char_level else r.split()
        h_toks = list(h.replace(" ", "")) if char_level else h.split()
        e, s, i, d = edit_distance(r_toks, h_toks)
        tot_err += e
        tot_sub += s
        tot_ins += i
        tot_del += d
        tot_words += len(r_toks)
        sent_err += int(e > 0)
    n = max(tot_words, 1)
    return {
        "wer": 100.0 * tot_err / n,
        "errors": tot_err, "sub": tot_sub, "ins": tot_ins,
        "del": tot_del, "num_words": tot_words,
        "ser": 100.0 * sent_err / max(len(ref_list), 1),
    }


def oracle_wer(refs, nbest, char_level=False):
    """Best-achievable WER over n-best hypotheses
    (cat/utils/wer.py oracle mode)."""
    tot_err, tot_words = 0, 0
    for uid, ref in refs.items():
        r_toks = (list(ref.replace(" ", "")) if char_level
                  else ref.split())
        best = None
        for _, hyp in sorted(nbest.get(uid, {}).items()):
            text = hyp[1] if isinstance(hyp, tuple) else hyp
            h_toks = (list(text.replace(" ", "")) if char_level
                      else text.split())
            e, *_ = edit_distance(r_toks, h_toks)
            best = e if best is None else min(best, e)
        tot_err += best if best is not None else len(r_toks)
        tot_words += len(r_toks)
    return {"wer": 100.0 * tot_err / max(tot_words, 1),
            "errors": tot_err, "num_words": tot_words}
