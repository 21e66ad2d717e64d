"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked `cuda`, and skips
elsewhere. The file imports nothing of JAX (the machine with the card has
none), so it runs there without the repo's JAX conftest:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes cover what chip_smoke.py's serving batch does not: every width the
kernels take, ragged row counts, lengths of 1 and T, T of 1 and past 512.
Tolerance, bf16: |kernel - plain| <= 0.02 + 0.02·|plain|.
"""
import pytest
import torch

from cat_tpu_torch.ctc.train import build_model
from cat_tpu_torch.models.layers import length_mask
from cat_tpu_torch.ops import attention, conv_module, ffn

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the port's CUDA kernels")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, s=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * s).to(dtype)


def _close(got, want, mask=None):
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("D,F,N,T", [(128, 512, 1, 1), (256, 1024, 3, 11),
                                     (384, 1536, 2, 33), (512, 2048, 2, 50)])
def test_ffn_kernel(gen, D, F, N, T):
    x = _rnd(gen, N, T, D, dtype=torch.bfloat16)
    p = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, F, s=D ** -0.5), _rnd(gen, F, s=0.1),
         _rnd(gen, F, D, s=F ** -0.5), _rnd(gen, D, s=0.1))
    before = ffn.fused_ff_residual.launches
    got = ffn.fused_ff_residual(x, *p, alpha=1.0)
    assert ffn.fused_ff_residual.launches == before + 1
    _close(got, ffn.ff_reference(x, *p, alpha=1.0))


@pytest.mark.parametrize("D,N,T", [(128, 1, 1), (256, 3, 11), (384, 2, 33),
                                   (512, 2, 50)])
def test_conv_module_kernels(gen, D, N, T):
    bf = torch.bfloat16
    x, c = _rnd(gen, N, T, D, dtype=bf), _rnd(gen, N, T, D, dtype=bf)
    mask = length_mask(torch.tensor([T] + [max(T // 2, 1)] * (N - 1),
                                    device="cuda"), T)
    g = (1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, 2 * D, s=D ** -0.5), _rnd(gen, 2 * D, s=0.1))
    _close(conv_module.fused_glu_in(x, mask, *g),
           conv_module.glu_in_reference(x, mask, *g))
    b = (_rnd(gen, D, s=0.1), 1 + _rnd(gen, D, s=0.2).abs(),
         1 + _rnd(gen, D, s=0.1), _rnd(gen, D, s=0.1),
         _rnd(gen, D, D, s=D ** -0.5), _rnd(gen, D, s=0.1))
    _close(conv_module.fused_bn_out(c, x, mask, *b),
           conv_module.bn_out_reference(c, x, mask, *b))


@pytest.mark.parametrize("N,T,H,Dh", [(1, 1, 1, 64), (2, 7, 2, 16),
                                      (3, 65, 2, 32), (2, 130, 4, 64),
                                      (2, 700, 2, 128)])
def test_attention_kernel(gen, N, T, H, Dh):
    bf = torch.bfloat16
    q, k, v = (_rnd(gen, N, T, H, Dh, dtype=bf) for _ in range(3))
    p = _rnd(gen, 2 * T - 1, H, Dh, s=0.5, dtype=bf)
    u, vb = _rnd(gen, H, Dh, s=0.1, dtype=bf), _rnd(gen, H, Dh, s=0.1,
                                                      dtype=bf)
    lengths = torch.tensor([T] + [1 + (7 * i) % T for i in range(1, N)],
                           device="cuda")
    got = attention.relpos_attention(q, k, v, p, u, vb, lengths)
    valid = length_mask(lengths, T)
    _close(got, attention.relpos_attention_reference(q, k, v, p, u, vb,
                                                     lengths), valid)
    assert (got[~valid] == 0).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x32 = _rnd(gen, 2, 3, 256)
    p = (torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
         _rnd(gen, 256, 512), torch.zeros(512, device="cuda"),
         _rnd(gen, 512, 256), torch.zeros(256, device="cuda"))
    with pytest.raises(ValueError, match="bfloat16"):
        ffn.fused_ff_residual(x32, *p)
    x192 = _rnd(gen, 2, 3, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        conv_module.fused_glu_in(x192, torch.ones(2, 3, dtype=torch.bool,
                                                  device="cuda"),
                                 torch.ones(192, device="cuda"),
                                 torch.zeros(192, device="cuda"),
                                 _rnd(gen, 192, 384),
                                 torch.zeros(384, device="cuda"))


def test_conformer_forward_matches_plain_on_the_card(gen, monkeypatch):
    kw = dict(num_cells=2, hdim=256, num_heads=4, kernel_size=15,
              dropout_rate=0.0)
    cfg = {"encoder": {"type": "ConformerNet",
                       "kwargs": dict(kw, dtype="bfloat16")}}
    model = build_model(cfg, num_classes=11, device="cuda", seed=3)
    x = _rnd(gen, 3, 130, 80)
    lengths = torch.tensor([130, 97, 40], device="cuda")
    with torch.inference_mode():
        got, got_len = model(x, lengths)
        for mod, name, fn in (
                (ffn, "fused_ff_residual", ffn.ff_reference),
                (conv_module, "fused_glu_in", conv_module.glu_in_reference),
                (conv_module, "fused_bn_out", conv_module.bn_out_reference),
                (attention, "relpos_attention",
                 attention.relpos_attention_reference)):
            monkeypatch.setattr(mod, name, fn)
        want, want_len = model(x, lengths)
    assert torch.equal(got_len, want_len)
    valid = length_mask(got_len, got.shape[1])
    assert (got - want).abs()[valid].max().item() <= 0.1
    f32 = build_model({"encoder": {"type": "ConformerNet", "kwargs": kw}},
                      num_classes=11, device="cuda")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        f32(x, lengths)
