"""The port's Philox keep-mask (`cat_tpu_torch.ops.dropout`), the plain twin
of the CUDA kernels' mask (`csrc/common.cuh`).

Checks: Random123's known-answer vectors for Philox-4x32-10; the mask is a
pure function of (seed, stream, plane, row, column), so any slice of a
larger mask is the mask of that slice, a new seed or stream gives another
mask, and the same call gives the same mask; the keep rate at 0.1 is
within 5 binomial standard deviations of 0.9; and the train-mode
`Dropout` module draws its seeds from the generator it is handed.
"""
import torch

from cat_tpu_torch.models.layers import Dropout
from cat_tpu_torch.ops import dropout


def test_philox_known_answers():
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = dropout.philox4x32_10(*map(t, ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_mask_is_a_pure_function_of_its_coordinates():
    seed = (1234, 0xDEADBEEF)
    big = dropout.keep_mask(seed, 0, 3, 40, 70, 0.1)
    assert torch.equal(big, dropout.keep_mask(seed, 0, 3, 40, 70, 0.1))
    # a smaller call is the corner of the bigger one, whatever the tiling
    assert torch.equal(big[:2, :17, :33],
                       dropout.keep_mask(seed, 0, 2, 17, 33, 0.1))
    assert not torch.equal(big, dropout.keep_mask(seed, 1, 3, 40, 70, 0.1))
    assert not torch.equal(big, dropout.keep_mask((1235, 0xDEADBEEF), 0, 3,
                                                  40, 70, 0.1))
    assert dropout.keep_mask(seed, 0, 1, 5, 5, 0.0).all()


def test_keep_rate_within_binomial_bounds():
    n = 1000 * 1024
    keep = dropout.keep_mask((7, 11), 0, 1, 1000, 1024, 0.1).float().mean()
    sigma = (0.1 * 0.9 / n) ** 0.5
    assert abs(keep.item() - 0.9) < 5 * sigma
    assert dropout.threshold(0.1) == 429496729


def test_dropout_module_draws_from_its_generator():
    layer = Dropout(0.1).train()
    x = torch.ones(4, 6, 32)
    a = layer(x, torch.Generator().manual_seed(5))
    b = layer(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, torch.tensor(1.0 / 0.9).item()}
    assert torch.equal(layer.eval()(x), x)
