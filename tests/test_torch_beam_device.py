"""Port parity for the batched prefix beam on the device:
`cat_tpu_torch.ctc.decode_device.ctc_beam_search_device` against
`cat_tpu.ctc.decode_jax.ctc_beam_search_device` on the CPU, N = 3-4,
T <= 60, V <= 12, W in {4, 8, 17}: mixed lengths (one frame, a
utterance shorter than its padding), beta 0 and 0.5, a max_len that
truncates, and rows of equal log-probs (ties everywhere: the top-K and
top-W orders must send ties to the lower index as `jax.lax.top_k` does).

Tolerance: in every lane whose score lies above LOG_EPS / 2 the prefix
and its length are identical and the score within 1e-4 (measured: equal
or one f32 rounding apart); the live lanes are the same lanes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ctc.decode_jax import ctc_beam_search_device as jax_beam
from cat_tpu.ops.semiring import LOG_EPS
from cat_tpu_torch.ctc.decode_device import _seg_merge, _wrap32
from cat_tpu_torch.ctc.decode_device import ctc_beam_search_device as beam


def _log_probs(N, T, V, seed, uniform=()):
    x = np.random.default_rng(seed).standard_normal((N, T, V)) * 2
    lp = np.array(jax.nn.log_softmax(x.astype(np.float32), -1))
    for n, sl in uniform:
        lp[n, sl] = np.float32(np.log(1.0 / V))
    return lp


def _check(lp, lens, **kw):
    want = [np.asarray(a) for a in jax_beam(jnp.asarray(lp),
                                            jnp.asarray(lens), **kw)]
    got = [t.numpy() for t in beam(torch.from_numpy(lp),
                                   torch.from_numpy(lens), **kw)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    live = want[2] > LOG_EPS / 2
    np.testing.assert_array_equal(got[2] > LOG_EPS / 2, live)
    for n, k in zip(*np.nonzero(live)):
        assert got[1][n, k] == want[1][n, k], (n, k)
        np.testing.assert_array_equal(got[0][n, k, :got[1][n, k]],
                                      want[0][n, k, :want[1][n, k]])
    np.testing.assert_allclose(got[2][live], want[2][live], rtol=0, atol=1e-4)
    assert live[:, 0].all()
    return got


@pytest.mark.parametrize("W", [4, 8, 17])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_beam_matches_jax(W, beta):
    lp = _log_probs(4, 60, 12, seed=W)
    lens = np.array([60, 37, 1, 52], np.int32)
    _check(lp, lens, beam_width=W, topk=8, max_len=32, beta=beta)


@pytest.mark.parametrize("W", [4, 8, 17])
def test_beam_with_truncating_max_len_matches_jax(W):
    lp = _log_probs(3, 40, 9, seed=10 + W)
    lens = np.array([40, 40, 23], np.int32)
    got = _check(lp, lens, beam_width=W, topk=6, max_len=4, beta=0.5)
    assert (got[1] >= 4).any()  # the cap binds


@pytest.mark.parametrize("W", [4, 8, 17])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_beam_on_tied_rows_matches_jax(W, beta):
    """Whole utterances and stretches of frames of equal log-probs."""
    lp = _log_probs(4, 30, 7, seed=20 + W,
                    uniform=[(1, slice(None)), (2, slice(5, 17)),
                             (3, slice(0, 3))])
    lens = np.array([30, 30, 25, 12], np.int32)
    _check(lp, lens, beam_width=W, topk=7, max_len=32, beta=beta)


def test_top_k_wider_than_the_vocabulary():
    lp = _log_probs(3, 20, 5, seed=3)
    _check(lp, np.array([20, 14, 9], np.int32), beam_width=8, topk=8,
           max_len=16)


def test_hashes_wrap_as_int32():
    x = torch.tensor([2 ** 31 - 1, -2 ** 31, 123456789 * 1000003 + 7,
                      -(987654321 * 1009) - 1])
    want = np.array([2 ** 31 - 1, -2 ** 31, 123456789 * 1000003 + 7,
                     -(987654321 * 1009) - 1]).astype(np.int32)
    np.testing.assert_array_equal(_wrap32(x).numpy(), want)


def test_segmented_merge_is_a_segmented_logaddexp():
    """The doubling scan against a loop: the last position of each run
    holds the log-sum-exp of the run."""
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((3, 37)).astype(np.float32)
    vals[1, 5:9] = LOG_EPS
    flags = rng.random((3, 37)) < 0.3
    flags[:, 0] = True
    out = _seg_merge(torch.from_numpy(vals), torch.from_numpy(flags)).numpy()
    for n in range(3):
        start = 0
        for i in range(1, 38):
            if i == 37 or flags[n, i]:
                run = vals[n, start:i].astype(np.float64)
                run = run[run > LOG_EPS / 2]
                want = np.logaddexp.reduce(run) if len(run) else LOG_EPS
                np.testing.assert_allclose(out[n, i - 1], want, rtol=1e-5)
                start = i


@pytest.mark.parametrize("W", [4, 17])
def test_float64_log_probs_search_in_float64(W):
    """float64 log-probs give the float64 search (the card beam's witness
    in chip_smoke.py): scores in float64, the same prefixes as the
    float32 search on these inputs, scores within f32 rounding of it."""
    lp = torch.from_numpy(_log_probs(5, 40, 9, 3))
    lens = torch.tensor([40, 33, 1, 20, 39])
    p32, l32, s32 = beam(lp, lens, beam_width=W, max_len=48)
    p64, l64, s64 = beam(lp.double(), lens, beam_width=W, max_len=48)
    assert s64.dtype == torch.float64 and s32.dtype == torch.float32
    assert torch.equal(p64, p32) and torch.equal(l64, l32)
    live = s64 > LOG_EPS / 2
    assert torch.equal(live, s32 > LOG_EPS / 2)
    np.testing.assert_allclose(s32[live].numpy(), s64[live].numpy(),
                               rtol=1e-5, atol=1e-4)
