"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the launch counters. Marked ``cuda``; without a GPU
every test skips. This file imports no JAX, so it runs on a host that has
none; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: K1 2e-2 (bf16 rounding of GEMV inputs
under two summation orders); K3 codes equal unless the reference's two
candidates are a near-tie, quantized sums to float32 rounding."""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("N", [1, 7, 8, 9, 300])  # 8 is the last split-over-K size
def test_rvq_kernel_matches_plain(cuda, N):
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    books = torch.randn((5, 1000, 64), device="cuda", generator=cuda)
    x = torch.randn((N, 64), device="cuda", generator=cuda)
    before = rvq_encode.launches
    codes, quant = rvq_encode(x, books)
    assert rvq_encode.launches == before + 1
    want_codes, want_quant = rvq_encode_reference(x, books)
    agree = (codes == want_codes).all(1)
    assert agree.float().mean() >= 0.99
    torch.testing.assert_close(quant[agree], want_quant[agree], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        rvq_encode(x[:, :63].contiguous(), books[..., :63].contiguous())  # D % 4 != 0


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_depformer_kernel_matches_plain(cuda, cache_dtype):
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference

    L, S, C, heads, H, card = 2, 8, 256, 4, 384, 256

    def w(*shape):
        return (torch.randn(shape, device="cuda", generator=cuda) * shape[-1] ** -0.5).bfloat16()

    ops = [1 + 0.1 * torch.randn((L, C), device="cuda", generator=cuda), w(L, S * 3 * C, C),
           w(L, S * C, C), 1 + 0.1 * torch.randn((L, C), device="cuda", generator=cuda),
           w(L, S, 2 * H, C), w(L, S, C, H), w(S, card, C),
           0.1 * torch.randn((S, card), device="cuda", generator=cuda)]
    xs = torch.randn((S, 1, C), device="cuda", generator=cuda).bfloat16()
    caches = [torch.zeros((L, S, C), device="cuda", dtype=cache_dtype) for _ in range(4)]
    before = depformer_step.launches
    for cb in range(S):
        got, caches[0], caches[1] = depformer_step(xs[cb], cb, *ops, caches[0], caches[1],
                                                   heads=heads)
        want, caches[2], caches[3] = depformer_step_reference(xs[cb], cb, *ops, caches[2],
                                                              caches[3], heads=heads)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    assert depformer_step.launches == before + S
    torch.testing.assert_close(caches[0].float(), caches[2].float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError):
        depformer_step(xs[0].float(), 0, *ops, caches[0], caches[1], heads=heads)
