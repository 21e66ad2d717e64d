"""Port parity for the monotonic (RNA / CTC-topology) transducer loss,
`cat_tpu_torch.ops.rnnt_rna.rnnt_loss_rna`, on the CPU: against
`cat_tpu.ops.rnnt_rna.rnnt_loss_rna` (per-sequence NLL and the gradient
with respect to the logits before the log-softmax, float32, rtol 1e-5,
atol 1e-5) and against a brute-force sum over every monotonic path (1e-4
in float64), including an utterance with no labels and one with frames
past its length; and `rnnt.train.make_loss_fn` taking topo "rna" and
"ctct" (the same loss) where it raised before.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cat_tpu.ops.rnnt_rna import rnnt_loss_rna as jax_rna
from cat_tpu_torch.ops.rnnt_rna import rnnt_loss_rna
from cat_tpu_torch.rnnt import train
from tests.test_torch_transducer import CFG, V, _torch_batch

torch.set_num_threads(2)


def brute_force(lp, labels, T, U, blank=0):
    """-log of the sum over the monotonic paths: exactly U of the T frames
    emit the next label, the others blank."""
    total = -math.inf
    for positions in itertools.combinations(range(T), U):
        u, w = 0, 0.0
        for t in range(T):
            if u < U and t == positions[u]:
                w += lp[t, u, labels[u]]
                u += 1
            else:
                w += lp[t, u, blank]
        total = np.logaddexp(total, w)
    return -total


def _case(seed, N=4, T=7, U=3, Vc=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, T, U + 1, Vc)).astype(np.float32) * 2
    labels = rng.integers(1, Vc, (N, U)).astype(np.int32)
    il = np.array([7, 6, 4, 5], np.int32)[:N]
    ul = np.array([3, 2, 3, 0], np.int32)[:N]
    labels *= np.arange(U)[None, :] < ul[:, None]
    return logits, labels, il, ul


@pytest.mark.parametrize("seed", [0, 1])
def test_rna_loss_and_gradient_match_jax(seed):
    logits, labels, il, ul = _case(seed)

    def jax_loss(x):
        return jnp.sum(jax_rna(jax.nn.log_softmax(x, -1), jnp.asarray(labels),
                               jnp.asarray(il), jnp.asarray(ul),
                               reduction="none") * jnp.arange(1.0, 5.0))

    want_nll = jax_rna(jax.nn.log_softmax(jnp.asarray(logits), -1),
                       jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ul),
                       reduction="none")
    want_grad = jax.grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    nll = rnnt_loss_rna(torch.log_softmax(x, -1), torch.from_numpy(labels),
                        torch.from_numpy(il), torch.from_numpy(ul),
                        reduction="none")
    (nll * torch.arange(1.0, 5.0)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(x.grad).all()


def test_rna_loss_matches_the_sum_over_paths():
    logits, labels, il, ul = _case(2)
    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1)
    nll = rnnt_loss_rna(lp, torch.from_numpy(labels), torch.from_numpy(il),
                        torch.from_numpy(ul), reduction="none")
    lpn = lp.numpy()
    for n in range(len(il)):
        want = brute_force(lpn[n], labels[n], int(il[n]), int(ul[n]))
        assert abs(nll[n].item() - want) < 1e-4, (n, nll[n].item(), want)
    for red, f in (("mean", torch.mean), ("sum", torch.sum)):
        got = rnnt_loss_rna(lp, torch.from_numpy(labels),
                            torch.from_numpy(il), torch.from_numpy(ul),
                            reduction=red)
        torch.testing.assert_close(got, f(nll))


@pytest.mark.parametrize("topo", ["rna", "ctct"])
def test_train_loss_takes_the_monotonic_topologies(topo):
    model = train.build_model(CFG, V, device="cpu").train()
    b = _torch_batch()
    loss, per_seq = train.make_loss_fn(model, topo=topo)(b, None, True)
    with torch.no_grad():
        out, olens = model(b["feats"], b["feat_lengths"], b["labels"],
                           b["label_lengths"])
        want = rnnt_loss_rna(torch.log_softmax(out, -1), b["labels"], olens,
                             b["label_lengths"], reduction="none")
    torch.testing.assert_close(per_seq.detach(), want)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
