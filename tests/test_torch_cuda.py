"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the launch counters. Marked ``cuda``; without a GPU
every test skips. This file imports no JAX, so it runs on a host that has
none; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: K1 and K1-int8 2e-2 (bf16 rounding of
GEMV inputs under two summation orders); K2, K4 and K5 1e-4 relative and
1e-5 absolute for float32 outputs (float32 sums in two orders; K2's
tensor-core route adds the ~2**-17 its hi + lo bf16 split leaves out, which
``tests/test_torch_ffn.py`` bounds against the Pallas kernel, and K4's and
K5's likewise, bounded in ``tests/test_torch_gating_ffn.py``), plus one bf16
step (2**-7 relative) for bf16 outputs; K3 codes equal on 99 % of the rows
(the rest near-ties of the two summation orders), quantized sums of agreeing
rows to float32 rounding, exact ties to the lower index."""

import torch

try:  # first: one torch CPU thread a process
    import tests.test_torch_threads  # noqa: F401
except ModuleNotFoundError:  # a `tests` package of another project on the path shadows this one
    torch.set_num_threads(1)

import pytest  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("N", [1, 7, 8, 9, 16, 32, 64, 300])
@pytest.mark.parametrize("split_max_rows", [0, 64])  # the tiled path; the split path to 64 rows
def test_rvq_kernel_matches_plain(cuda, monkeypatch, N, split_max_rows):
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    monkeypatch.setattr(cuda_rvq, "SPLIT_MAX_ROWS", split_max_rows)

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


RVQ_PATHS = {"split": 64, "tiled": 0}  # SPLIT_MAX_ROWS that routes N <= 64 rows to each path


def _rvq_agree(codes, quant, want_codes, want_quant):
    agree = (codes == want_codes).all(1)
    assert agree.float().mean() >= 0.99
    torch.testing.assert_close(quant[agree], want_quant[agree], rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", list(RVQ_PATHS))
@pytest.mark.parametrize("D", [64, 256, 512])
@pytest.mark.parametrize("Q", [1, 7, 8])
def test_rvq_kernel_shapes_on_both_paths(cuda, monkeypatch, path, D, Q):
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    monkeypatch.setattr(cuda_rvq, "SPLIT_MAX_ROWS", RVQ_PATHS[path])
    books = torch.randn((Q, 2048, D), device="cuda", generator=cuda)
    x = torch.randn((48, D), device="cuda", generator=cuda)
    _rvq_agree(*rvq_encode(x, books), *rvq_encode_reference(x, books))


@pytest.mark.parametrize("path", list(RVQ_PATHS))
@pytest.mark.parametrize("lo,hi", [(15, 16), (127, 128), (5, 1500), (1023, 1024)])
def test_rvq_kernel_exact_tie_takes_lower_index(cuda, monkeypatch, path, lo, hi):
    """A codeword duplicated at two indices: across a split-path block's
    slice (16 codewords a block on 128 SMs or more), across a tiled-path
    codebook tile (128) and across the two halves of a tiled cluster; the
    lower index wins on both paths, at every row."""
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode

    monkeypatch.setattr(cuda_rvq, "SPLIT_MAX_ROWS", RVQ_PATHS[path])
    books = torch.randn((2, 2048, 256), device="cuda", generator=cuda)
    books[0, hi] = books[0, lo]
    for n in (4, 64):
        x = books[0, lo].repeat(n, 1) + 0.01 * torch.randn((n, 256), device="cuda", generator=cuda)
        codes, _ = rvq_encode(x, books)
        assert codes[:, 0].tolist() == [lo] * n


@pytest.mark.parametrize("path", list(RVQ_PATHS))
def test_rvq_kernel_is_bit_identical_across_calls(cuda, monkeypatch, path):
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode

    monkeypatch.setattr(cuda_rvq, "SPLIT_MAX_ROWS", RVQ_PATHS[path])
    books = torch.randn((7, 2048, 256), device="cuda", generator=cuda)
    for n in (1, 16, 64):
        x = torch.randn((n, 256), device="cuda", generator=cuda)
        (c1, q1), (c2, q2) = rvq_encode(x, books), rvq_encode(x, books)
        assert torch.equal(c1, c2) and torch.equal(q1, q2)


@pytest.mark.parametrize("path", list(RVQ_PATHS))
def test_rvq_kernel_all_nan_row_gets_code_zero(cuda, monkeypatch, path):
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode

    monkeypatch.setattr(cuda_rvq, "SPLIT_MAX_ROWS", RVQ_PATHS[path])
    books = torch.randn((7, 2048, 256), device="cuda", generator=cuda)
    x = torch.randn((8, 256), device="cuda", generator=cuda)
    x[3] = float("nan")
    codes, _ = rvq_encode(x, books)
    assert codes[3].tolist() == [0] * 7


@pytest.mark.parametrize("path", list(RVQ_PATHS) + ["wrapper"])
@pytest.mark.parametrize("Q", [1, 7])
@pytest.mark.parametrize("N", [50, 152])
def test_rvq_kernel_at_codec_training_shapes(cuda, monkeypatch, path, Q, N):
    """The trainable quantizer's sweep (D=64, K=2048; rvq_first Q=1, rvq_rest
    Q=7): N=152 rows a training step at batch 4 x 72000 samples (the wrapper
    takes the tiled path), N=50 a 4 s clip of codec_infer (the split path)."""
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    if path != "wrapper":
        if N > 64 and path == "split":
            pytest.skip("the split path takes up to 64 rows")
        monkeypatch.setattr(cuda_rvq, "SPLIT_MAX_ROWS", RVQ_PATHS[path])
    books = torch.randn((Q, 2048, 64), device="cuda", generator=cuda)
    x = torch.randn((N, 64), device="cuda", generator=cuda)
    (c1, q1), (c2, q2) = rvq_encode(x, books), rvq_encode(x, books)
    assert torch.equal(c1, c2) and torch.equal(q1, q2)
    _rvq_agree(c1, q1, *rvq_encode_reference(x, books))


def test_trainable_rvq_on_card_matches_cpu(cuda):
    """TrainableSplitRVQ at mimi24k's widths (512 -> 64, 2048 codes, 1 + 7
    levels) over one training step's latents (4 x 38 frames): two K3
    launches; codes, outputs and EMA buffers equal to the CPU's (the
    plain version) up to near-ties and float32 rounding; the same draws."""
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
    from rstnet_tpu_torch.quantization.trainable import TrainableSplitRVQ

    cpu = TrainableSplitRVQ(input_dimension=512, dimension=64, bins=2048, n_q=8,
                            generator=torch.Generator().manual_seed(0))
    card = TrainableSplitRVQ(input_dimension=512, dimension=64, bins=2048, n_q=8,
                             generator=torch.Generator().manual_seed(0)).cuda()
    x = torch.randn((4, 38, 512), generator=torch.Generator().manual_seed(1))
    before = rvq_encode.launches
    out_c, codes_c, commit_c, _ = cpu(x, generator=torch.Generator().manual_seed(2))
    out_g, codes_g, commit_g, _ = card(x.cuda(), generator=torch.Generator().manual_seed(2))
    assert rvq_encode.launches == before + 2
    agree = (codes_g.cpu() == codes_c).all(-1)
    assert agree.float().mean() >= 0.99
    torch.testing.assert_close(out_g.cpu()[agree], out_c[agree], rtol=1e-5, atol=1e-5)
    if bool(agree.all()):
        torch.testing.assert_close(commit_g.cpu(), commit_c, rtol=1e-5, atol=1e-6)
        for name, buf in cpu.named_buffers():
            torch.testing.assert_close(card.get_buffer(name).cpu(), buf, rtol=1e-5, atol=1e-5)


def test_rvq_split_call_is_one_device_kernel(cuda):
    """A call up to SPLIT_MAX_ROWS rows is one cooperative launch: the
    profiler sees exactly one device event (the scratch is set once, on the
    first call of a stream)."""
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
    from rstnet_tpu_torch.tools.profile_frame import device_events

    books = torch.randn((7, 2048, 256), device="cuda", generator=cuda)
    for n in (1, 16, 64):
        x = torch.randn((n, 256), device="cuda", generator=cuda)
        rvq_encode(x, books)  # warm-up: builds the library, sets the scratch
        names = device_events(lambda: rvq_encode(x, books))
        assert len(names) == 1 and "rvq_split_kernel" in names[0], names


def _k1_operands(gen, L, S, C, heads, H, card, init="normal"):
    """K1's operands; ``init="uniform"`` draws the weights as the model
    initializes them, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    def w(*shape):
        if init == "uniform":
            u = torch.rand(shape, device="cuda", generator=gen) * 2 - 1
            return (u * shape[-1] ** -0.5).bfloat16()
        return (torch.randn(shape, device="cuda", generator=gen) * shape[-1] ** -0.5).bfloat16()

    ops = [1 + 0.1 * torch.randn((L, C), device="cuda", generator=gen), w(L, S * 3 * C, C),
           w(L, S * C, C), 1 + 0.1 * torch.randn((L, C), device="cuda", generator=gen),
           w(L, S, 2 * H, C), w(L, S, C, H), w(S, card, C),
           0.1 * torch.randn((S, card), device="cuda", generator=gen)]
    xs = torch.randn((S, 1, C), device="cuda", generator=gen).bfloat16()
    return ops, xs


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_depformer_kernel_matches_plain(cuda, cache_dtype):
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference

    L, S, C, heads, H, card = 2, 8, 256, 4, 384, 256
    ops, xs = _k1_operands(cuda, L, S, C, heads, H, card)
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


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(2, 8, 256, 4, 384, 256), (6, 8, 1024, 16, 2816, 2048)],
                         ids=["small", "moshi7b"])
def test_depformer_int8_kernel_matches_plain(cuda, cache_dtype, dims):
    """K1-int8 at a small and at Moshi 7B's depformer width: weights drawn as
    the model initializes them and quantized by the port's
    quantize_weight_int8, a frame of S micro-steps, against the plain
    version within K1's 2e-2; it counts in ``launches_int8`` only."""
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference

    L, S, C, heads, H, card = dims
    ops, xs = _k1_operands(cuda, L, S, C, heads, H, card, init="uniform")
    names = ("norm1", "in_proj", "out_proj", "norm2", "gin", "gout", "head_w", "head_b")
    ops = dict(zip(names, ops))
    scales = {}
    for k in ("in_proj", "out_proj", "gin", "gout", "head_w"):
        q = quantize_weight_int8(ops[k])
        ops[k], scales[k] = q.w_int8, q.scale[..., None]
    ops = [ops[k] for k in names]
    caches = [torch.zeros((L, S, C), device="cuda", dtype=cache_dtype) for _ in range(4)]
    bf16, int8 = depformer_step.launches, depformer_step.launches_int8
    for cb in range(S):
        got, caches[0], caches[1] = depformer_step(xs[cb], cb, *ops, caches[0], caches[1],
                                                   heads=heads, scales=scales)
        want, caches[2], caches[3] = depformer_step_reference(
            xs[cb], cb, *ops, caches[2], caches[3], heads=heads, scales=scales)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    assert (depformer_step.launches, depformer_step.launches_int8) == (bf16, int8 + S)
    for a, b in ((caches[0], caches[2]), (caches[1], caches[3])):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError):  # int8 weights need their scales
        depformer_step(xs[0], 0, *ops, caches[0], caches[1], heads=heads)


def test_small_int8_slice_card_matches_cpu(cuda):
    """The small solo frame under --int8 --kv-int8 on the card (K1-int8)
    against the CPU, teacher-forced (``chip_smoke.check_small_slice``: logits
    within 5e-2 of their scale, audio within 1e-3, K1-int8 8 times a frame)."""
    import chip_smoke

    chip_smoke.check_small_slice(0, n_frames=4, int8=True)


K1_SHAPES = {  # (L, S, C, heads, H, card)
    "flagship": (6, 8, 1024, 16, 768, 2048),  # the codecformer after pad_codecformer_gating
    "smallest": (1, 1, 128, 1, 128, 128),
}


def _k1_case(gen, dims, int8):
    """K1's operands at ``dims`` (weights drawn as the model initializes
    them; int8: quantized by the port's quantize_weight_int8) as a list in
    the wrappers' order, and the scales (None for bf16)."""
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8

    L, S, C, heads, H, card = dims
    ops, xs = _k1_operands(gen, L, S, C, heads, H, card, init="uniform")
    names = ("norm1", "in_proj", "out_proj", "norm2", "gin", "gout", "head_w", "head_b")
    ops = dict(zip(names, ops))
    scales = None
    if int8:
        scales = {}
        for k in ("in_proj", "out_proj", "gin", "gout", "head_w"):
            q = quantize_weight_int8(ops[k])
            ops[k], scales[k] = q.w_int8, q.scale[..., None]
    return [ops[k] for k in names], xs, scales


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_depformer_kernels_at_flagship_and_smallest_shapes(cuda, shape, int8, cache_dtype):
    """K1 and K1-int8 over a frame of S micro-steps against the plain
    version, logits and caches within 2e-2, at the flagship codecformer's
    shape and at the smallest the kernel takes (one layer, step, head)."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference

    dims = K1_SHAPES[shape]
    L, S, C, heads = dims[:4]
    ops, xs, scales = _k1_case(cuda, dims, int8)
    caches = [torch.zeros((L, S, C), device="cuda", dtype=cache_dtype) for _ in range(4)]
    for cb in range(S):
        got, caches[0], caches[1] = depformer_step(xs[cb], cb, *ops, caches[0], caches[1],
                                                   heads=heads, scales=scales)
        want, caches[2], caches[3] = depformer_step_reference(
            xs[cb], cb, *ops, caches[2], caches[3], heads=heads, scales=scales)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    for a, b in ((caches[0], caches[2]), (caches[1], caches[3])):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_depformer_kernel_is_bit_identical_across_calls(cuda, int8):
    """Two frames from the same inputs give the same logits and caches, bit
    for bit: every output is summed by one warp in a fixed order."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step

    dims = K1_SHAPES["flagship"]
    L, S, C, heads = dims[:4]
    ops, xs, scales = _k1_case(cuda, dims, int8)
    runs = []
    for _ in range(2):
        kc, vc = (torch.zeros((L, S, C), device="cuda") for _ in range(2))
        logits = []
        for cb in range(S):
            lg, kc, vc = depformer_step(xs[cb], cb, *ops, kc, vc, heads=heads, scales=scales)
            logits.append(lg)
        runs.append((torch.stack(logits), kc, vc))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_depformer_micro_step_is_one_device_kernel(cuda, int8):
    """A micro-step is one cooperative launch: the profiler sees exactly one
    device event, the micro-step kernel."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step
    from rstnet_tpu_torch.tools.profile_frame import device_events

    dims = K1_SHAPES["flagship"]
    L, S, C, heads = dims[:4]
    ops, xs, scales = _k1_case(cuda, dims, int8)
    kc, vc = (torch.zeros((L, S, C), device="cuda") for _ in range(2))
    step = lambda cb: depformer_step(xs[cb], cb, *ops, kc, vc, heads=heads, scales=scales)  # noqa: E731
    step(0)  # warm-up: builds the library, allocates the barrier counter
    for cb in (1, S - 1):
        names = device_events(lambda: step(cb))
        assert len(names) == 1 and "dep_step_kernel" in names[0], names


@pytest.mark.parametrize("B", [1, 9, 64, 300])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_gating_ffn_step_kernel_matches_plain(cuda, B, x_dtype, w_dtype):
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn_step, gating_ffn_step_reference

    S, C, H = 4, 256, 384
    x = torch.randn((B, C), device="cuda", generator=cuda).to(x_dtype)
    lin_in = (torch.rand((S, 2 * H, C), device="cuda", generator=cuda) * 2 - 1) * C**-0.5
    lin_out = (torch.rand((S, C, H), device="cuda", generator=cuda) * 2 - 1) * H**-0.5
    lin_in, lin_out = lin_in.to(w_dtype), lin_out.to(w_dtype)
    for step in (0, 3, 7):  # 7 clamps to S - 1
        before = gating_ffn_step.launches
        got = gating_ffn_step(x, lin_in, lin_out, step)
        assert gating_ffn_step.launches == before + 1
        want = gating_ffn_step_reference(x, lin_in, lin_out, step)
        assert got.dtype == x_dtype and got.shape == (B, C)
        rtol = 1e-4 if x_dtype == torch.float32 else 2.0**-7
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5)
    with pytest.raises(ValueError):
        gating_ffn_step(x[:, :100].contiguous(), lin_in[..., :100].contiguous(),
                        lin_out[:, :100].contiguous(), 0)  # C % 8 != 0


@pytest.mark.parametrize("schedule", [(1, 1), (1, 6), (2, 1), (4, 2), (8, 3)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gating_ffn_step_schedules_match_plain(cuda, schedule, x_dtype):
    """K2 at the flagship codecformer's width (C=1024, H=768) and B=60 (a
    last group of rows short of its tile) on every (groups, splits) given,
    and on ``k2_schedule``'s own: each within the route's tolerance of the
    plain version, and two calls bit for bit."""
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn_step, gating_ffn_step_reference

    S, C, H, B = 4, 1024, 768, 60
    x = torch.randn((B, C), device="cuda", generator=cuda).to(x_dtype)
    lin_in = ((torch.rand((S, 2 * H, C), device="cuda", generator=cuda) * 2 - 1)
              * C**-0.5).bfloat16()
    lin_out = ((torch.rand((S, C, H), device="cuda", generator=cuda) * 2 - 1)
               * H**-0.5).bfloat16()
    want = gating_ffn_step_reference(x, lin_in, lin_out, 2).float()
    rtol = 1e-4 if x_dtype == torch.float32 else 2.0**-7
    for sched in (schedule, None):
        got = gating_ffn_step(x, lin_in, lin_out, 2, schedule=sched)
        assert torch.equal(got, gating_ffn_step(x, lin_in, lin_out, 2, schedule=sched))
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("B", [2, 16, 64])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gating_ffn_step_kernel_is_bit_identical_across_calls(cuda, B, x_dtype):
    """K2 at Moshi 7B's depformer width (the down pass split over H, its
    partial sums added by the last block in split order): two calls give the
    same output, bit for bit."""
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn_step

    S, C, H = 8, 1024, 2816
    x = torch.randn((B, C), device="cuda", generator=cuda).to(x_dtype)
    lin_in = ((torch.rand((S, 2 * H, C), device="cuda", generator=cuda) * 2 - 1)
              * C**-0.5).bfloat16()
    lin_out = ((torch.rand((S, C, H), device="cuda", generator=cuda) * 2 - 1)
               * H**-0.5).bfloat16()
    assert torch.equal(gating_ffn_step(x, lin_in, lin_out, 5), gating_ffn_step(x, lin_in, lin_out, 5))


@pytest.mark.parametrize("N", [1, 4, 16, 64, 100])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,H", [(2048, 8192), (128, 384), (136, 392)],
                         ids=["llama-1b", "small", "off-grid"])
def test_gating_ffn_kernels_match_plain(cuda, N, x_dtype, C, H):
    """K4 (bf16 weights, and the same weights in float32) and K5 (int8
    weights from the port's quantizer) at Llama-3.2-1B's MLP, at a small
    width on the tensor cores' 128 grid and at one off it (the CUDA-core
    kernels), N from 1 to past the 64 rows of one launch chain, x in bf16
    and float32, each against its plain version; two calls give the same
    bits. Each wrapper counts its launch (K4 over float32 weights in
    ``launches_f32w``); on the grid, a bf16-x call over float32 weights is
    the three device kernels of the tensor-core route and no weight cast."""
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
    from rstnet_tpu_torch.ops.cuda_ffn import (
        gating_ffn,
        gating_ffn_int8,
        gating_ffn_int8_reference,
        gating_ffn_reference,
    )
    from rstnet_tpu_torch.tools.profile_frame import device_events

    def uniform(rows, cols):
        return (torch.rand((rows, cols), device="cuda", generator=cuda) * 2 - 1) * cols**-0.5

    w = [uniform(H, C).bfloat16(), uniform(H, C).bfloat16(), uniform(C, H).bfloat16()]
    w32 = [t.float() for t in w]
    q = [quantize_weight_int8(t) for t in w]
    q_args = [t for wq in q for t in (wq.w_int8.data, wq.scale.data)]
    x = torch.randn((N, C), device="cuda", generator=cuda).to(x_dtype)
    rtol = 1e-4 if x_dtype == torch.float32 else 2.0**-7
    for kernel, plain, args, counter in (
            (gating_ffn, gating_ffn_reference, w, "launches"),
            (gating_ffn, gating_ffn_reference, w32, "launches_f32w"),
            (gating_ffn_int8, gating_ffn_int8_reference, q_args, "launches")):
        before = getattr(kernel, counter)
        got = kernel(x, *args)
        assert getattr(kernel, counter) == before + 1
        assert torch.equal(kernel(x, *args), got)
        want = plain(x, *args)
        assert got.dtype == x_dtype and got.shape == (N, C)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5)
    if x_dtype == torch.bfloat16 and C % 128 == 0 and H % 128 == 0 and N <= 64:
        names = device_events(lambda: gating_ffn(x, *w32))
        assert len(names) == 3 and all(any(k in n for n in names) for k in (
            "gate_value_tc", "down_tc", "sum_down_splits")), names
    with pytest.raises(ValueError):
        gating_ffn(x[:, :100].contiguous(), *(t[:, :100].contiguous() for t in w[:2]),
                   w[2][:100].contiguous())  # C % 8 != 0


@pytest.mark.parametrize("N", [1, 2, 64])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,H", [(2048, 4096), (136, 392)], ids=["tp-shard", "off-grid"])
def test_gating_ffn_float32_partial_matches_plain(cuda, N, w_dtype, C, H):
    """K4 with a float32 output (a tensor-parallel rank's partial of the
    down product) at the flagship's MLP shard over ``tensor`` = 2 and at a
    width off the 128 grid, x in the weights' dtype: against its plain
    version, two calls bit for bit."""
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn, gating_ffn_reference

    w = [((torch.rand(shape, device="cuda", generator=cuda) * 2 - 1) * shape[1]**-0.5).to(w_dtype)
         for shape in ((H, C), (H, C), (C, H))]
    x = torch.randn((N, C), device="cuda", generator=cuda).to(w_dtype)
    got = gating_ffn(x, *w, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (N, C)
    assert torch.equal(gating_ffn(x, *w, out_dtype=torch.float32), got)
    torch.testing.assert_close(got, gating_ffn_reference(x, *w, out_dtype=torch.float32),
                               rtol=1e-4, atol=1e-5)


def _card_batcher(seed=0, **kwargs):
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.batcher import SessionBatcher
    from rstnet_tpu_torch.serving.server import build_models

    mimi, gen = build_models(True, torch.device("cuda"), seed)
    gen = LMGen(gen.model, delays=gen.model.delays, use_sampling=False)
    return SessionBatcher(mimi, gen, max_sessions=2, dtype=torch.float32, **kwargs)


@pytest.mark.parametrize("depth,pool_env,async_env,wire", [
    (2, None, None, "float32"),  # pinned copy + event at dispatch, waited in the pool
    (2, "0", None, "float32"),  # pinned copy + event, waited in the tick thread
    (2, None, "0", "float32"),  # the pool copies synchronously
    (1, None, None, "int16"),  # PCM converted on the card both ways
])
def test_batcher_fetch_paths_on_card_match_depth1(cuda, monkeypatch, depth, pool_env, async_env,
                                                  wire):
    """The card's fetch paths deliver the frames of the synchronous depth-1
    float32 clock: tokens equal, audio equal (within one pcm16 step for the
    int16 wire, on silence)."""
    import numpy as np

    frames = np.random.default_rng(0).normal(0, 0.1, (6, 1920)).astype(np.float32)
    if wire == "int16":
        frames[:] = 0.0  # silence quantizes exactly: the same codes on both wires
    streams = []
    for case in ((1, None, None, "float32"), (depth, pool_env, async_env, wire)):
        for name, val in zip(("RSTNET_BATCHER_FETCH_POOL", "RSTNET_BATCHER_ASYNC_FETCH"),
                             case[1:3]):
            if val is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, val)
        b = _card_batcher(pipeline_depth=case[0], wire_dtype=case[3])
        sess = b.acquire()
        for i in range(len(frames) + case[0] - 1):  # depth - 1 flush ticks
            if i < len(frames):
                sess.inputs.put_nowait(frames[i])
            b.step_once()
        streams.append([sess.outputs.get_nowait() for _ in range(sess.outputs.qsize())])
    assert len(streams[0]) == len(streams[1]) > 0
    for (a0, t0), (a1, t1) in zip(*streams):
        assert t0 == t1
        np.testing.assert_allclose(a1, a0, rtol=0, atol=1.5 / 32767.0 if wire == "int16" else 0)


# K6: each output against its plain version at its own scale,
# ||kernel - plain|| / ||plain|| over the tensor and over every 64-row tile of
# every head (cuda_flash.relative_error_by_tile): 1e-2 on bf16 inputs (one
# bf16 rounding of ~2**-9 in the P V and dS products and the outputs on
# either side), 1e-4 on float32 inputs (split-bf16 products, a dropped term
# of ~2**-16; a bf16-only product reads ~2e-3). The log-sum-exp is float32
# on both sides: 1e-3 (bf16 inputs) or 1e-4; delta = rowsum(dO * O) is held
# to 1e-4 of its scale against the same sum over the kernel's own O.
K6_TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


def _k6_inputs(gen, B, H, Hkv, T, dtype, D=64):
    q, do = (torch.randn((B, H, T, D), device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Hkv, T, D), device="cuda", generator=gen).to(dtype) for _ in range(2))
    return (q * D**-0.5).to(dtype), k, v, do  # q pre-scaled, as the route passes it


def _k6_case(gen, B, H, Hkv, T, dtype, window, D=64):
    from rstnet_tpu_torch.ops import cuda_flash as cf

    q, k, v, do = _k6_inputs(gen, B, H, Hkv, T, dtype, D)
    fns = (cf.flash_attention_fwd, cf.flash_attention_bwd)
    attr = cf.COUNTERS[dtype, D]
    counts = [getattr(f, attr) for f in fns]
    o, lse = cf.flash_attention_fwd(q, k, v, window)
    dq, dk, dv, delta = cf.flash_attention_bwd(q, k, v, o, do, lse, window)
    torch.cuda.synchronize()
    assert [getattr(f, attr) for f in fns] == [c + 1 for c in counts]
    assert dk.shape == dv.shape == k.shape
    o_r, lse_r = cf.flash_attention_fwd_reference(q, k, v, window)
    dq_r, dk_r, dv_r, _ = cf.flash_attention_bwd_reference(q, k, v, o_r, do, lse_r, window)
    rel, lse_tol = K6_TOL[dtype]
    for name, got, want in (("o", o, o_r), ("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        whole, tile = cf.relative_error_by_tile(got, want)
        assert whole <= rel and tile <= rel, f"{name}: {whole:.3e} over the tensor, {tile:.3e} a tile"
    assert (lse - lse_r).abs().max().item() <= lse_tol
    delta_want = (do.float() * o.float()).sum(-1)  # from the kernel's own O
    assert (delta - delta_want).abs().max().item() <= 1e-4 * max(1.0, delta_want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,window", [(128, 128), (128, 100), (512, 512), (512, 100),
                                      (1024, 256), (1024, 1024)])
@pytest.mark.parametrize("heads", [(4, 4), (4, 1)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_match_plain(cuda, dtype, T, window, heads, D):
    """H = Hkv, and H = 4 Hkv (GQA inside the kernels), at both head dims."""
    _k6_case(cuda, 1, *heads, T, dtype, window, D)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_at_training_shapes(cuda, dtype):
    """B=2 and the main paths' B=4, 32 query heads over 8 KV heads, T=1024,
    bf16 and float32 (the split-bf16 route of float32 training): causal
    (context 3000 >= T) and local (256)."""
    for B in (2, 4):
        for window in (1024, 256):
            _k6_case(cuda, B, 32, 8, 1024, dtype, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [(28, 4), (32, 8)])
def test_flash_kernels_at_head_dim_128(cuda, dtype, heads):
    """Head dim 128 at B=4, T=1024: Qwen2.5-7B's 28 query heads over 4 KV
    heads (GQA 7:1) and Llama-3.1-8B's 32 over 8, causal and local (256),
    and under windows whose edge falls inside a key tile (100, 192)."""
    for window in (1024, 256, 100, 192):
        _k6_case(cuda, 4, *heads, 1024, dtype, window, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_smallest_grid(cuda, dtype):
    """B=1, T=128: one work item, one forward tile (the ordered dQ must not
    wait on itself); H=Hkv=1, and four query heads over one KV head under a
    window (the float32 forward's warpgroups pass over the key tile their
    rows do not see)."""
    for D in (64, 128):
        _k6_case(cuda, 1, 1, 1, 128, dtype, 128, D)
        _k6_case(cuda, 1, 4, 1, 128, dtype, 100, D)
    # head dim 128 at T=128 and T=384 (fewer work items than SMs, an odd
    # count of 128-key tiles, float32's 64-key items down to a pair a
    # head), GQA 7:1 and 1:1, causal and windowed
    for T in (128, 384):
        for H, Hkv in ((7, 1), (1, 1)):
            for window in (T, 100, 192):
                _k6_case(cuda, 1, H, Hkv, T, dtype, window, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [1024, 256, 100, 192])
@pytest.mark.parametrize("D,heads", [(64, (32, 8)), (128, (28, 4)), (128, (7, 1)),
                                     (128, (4, 4))])
def test_flash_backward_is_bit_identical_across_calls(cuda, window, dtype, D, heads):
    """dQ is summed in a fixed order (no atomics): two calls agree bit for
    bit (head dim 128 also at GQA 7:1 over one KV head and at 1:1)."""
    from rstnet_tpu_torch.ops import cuda_flash as cf

    q, k, v, do = _k6_inputs(cuda, 2, *heads, 1024, dtype, D)
    o, lse = cf.flash_attention_fwd(q, k, v, window)
    first = cf.flash_attention_bwd(q, k, v, o, do, lse, window)
    second = cf.flash_attention_bwd(q, k, v, o, do, lse, window)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_route_matches_reference(cuda):
    """The differentiable route (pre-scale, two kernels, K/V unrepeated)
    against autograd of the plain reference."""
    from rstnet_tpu_torch.ops.cuda_flash import relative_error_by_tile
    from rstnet_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    q = torch.randn((2, 8, 512, 64), device="cuda", generator=cuda).bfloat16().requires_grad_()
    k = torch.randn((2, 2, 512, 64), device="cuda", generator=cuda).bfloat16().requires_grad_()
    v = torch.randn((2, 2, 512, 64), device="cuda", generator=cuda).bfloat16().requires_grad_()
    do = torch.randn((2, 8, 512, 64), device="cuda", generator=cuda).bfloat16()
    for context in (3000, 200):
        got = flash_attention(q, k, v, context, 0.125)
        grads = torch.autograd.grad(got, (q, k, v), do)
        want = flash_attention_reference(q, k, v, context, 0.125)
        grads_r = torch.autograd.grad(want, (q, k, v), do)
        for a, b in zip((got, *grads), (want, *grads_r)):
            assert max(relative_error_by_tile(a, b)) <= K6_TOL[torch.bfloat16][0]


def test_flash_kernels_refuse_outside_envelope(cuda):
    from rstnet_tpu_torch.ops.cuda_flash import flash_attention_bwd, flash_attention_fwd

    def zeros(*shape):
        return torch.zeros(shape, device="cuda", dtype=torch.bfloat16)

    for D in (32, 96):
        x = zeros(1, 2, 128, D)
        with pytest.raises(ValueError):
            flash_attention_fwd(x, x, x, 128)  # head dims other than 64 and 128
    for T in (100, 64):  # T not a multiple of 128
        y = zeros(1, 2, T, 64)
        with pytest.raises(ValueError):
            flash_attention_fwd(y, y, y, T)
    q, kv = zeros(1, 3, 128, 64), zeros(1, 2, 128, 64)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, kv, kv, 128)  # H not a multiple of Hkv
    q, kv = zeros(1, 4, 128, 64), zeros(1, 2, 128, 64)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, kv, kv, kv, q, torch.zeros((1, 4, 128), device="cuda"), 128)  # o at Hkv
    with pytest.raises(TypeError):
        h = q.half()
        flash_attention_fwd(h, kv.half(), kv.half(), 128)


# -- the kernels and the serving steps inside captured CUDA graphs ------------


def _graph_cases(gen):
    """Each kernel of the serving path at a serving shape: (name, the
    wrapper, its static inputs, its keyword arguments)."""
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn, gating_ffn_int8, gating_ffn_step
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode

    def uniform(*shape):
        return (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) * shape[-1] ** -0.5

    cases = {}
    for int8 in (False, True):
        ops, xs, scales = _k1_case(gen, (6, 8, 1024, 16, 2816, 2048), int8)
        caches = [torch.zeros((6, 8, 1024), device="cuda") for _ in range(2)]
        cases["K1-int8" if int8 else "K1"] = (
            lambda x, *a, scales=scales: depformer_step(x, 3, *a, heads=16, scales=scales)[0],
            (xs[3], *ops, *caches))
    lin_in, lin_out = uniform(8, 2 * 2816, 1024).bfloat16(), uniform(8, 1024, 2816).bfloat16()
    cases["K2"] = (lambda x, a, b: gating_ffn_step(x, a, b, 5),
                   (torch.randn((16, 1024), device="cuda", generator=gen).bfloat16(), lin_in,
                    lin_out))
    cases["K3"] = (lambda x, b: rvq_encode(x, b), (torch.randn((7, 256), device="cuda", generator=gen),
                                                   torch.randn((7, 2048, 256), device="cuda",
                                                               generator=gen)))
    w = [uniform(8192, 2048).bfloat16(), uniform(8192, 2048).bfloat16(),
         uniform(2048, 8192).bfloat16()]
    x = torch.randn((1, 2048), device="cuda", generator=gen).bfloat16()
    cases["K4"] = (gating_ffn, (x, *w))
    q = [quantize_weight_int8(t) for t in w]
    cases["K5"] = (gating_ffn_int8, (x, *(t for wq in q for t in (wq.w_int8.data,
                                                                  wq.scale.data))))
    return cases


@pytest.mark.parametrize("name", ["K1", "K1-int8", "K2", "K3", "K4", "K5"])
def test_kernel_replays_in_a_graph_bit_for_bit(cuda, name):
    """Each serving kernel launched inside a captured CUDA graph (K1 and K3
    as cooperative launches, K2, K4 and K5 with programmatic dependent
    launch; K3 on its split path at 7 rows) and replayed 20 times: every
    replay's output equals the eager launch's, bit for bit, and the host
    counter counted the capture, not the replays."""
    from rstnet_tpu_torch.serving.graphs import CapturedStep

    fn, inputs = _graph_cases(cuda)[name]
    want = fn(*inputs)
    step = CapturedStep(lambda state, *ins: (fn(*ins), state), {}, inputs, name=name)
    step()  # the warm-up launch, on the capture stream
    for _ in range(20):
        got = step()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name
    assert step.captures == 1


def _card_state(scan_frames=4, graphs=True):
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.server import ServerState, build_models

    mimi, gen = build_models(True, torch.device("cuda"), 0)
    gen = LMGen(gen.model, delays=gen.model.delays, use_sampling=False)
    return ServerState(mimi, gen, scan_frames=scan_frames, cuda_graphs=graphs)


def test_server_state_graph_frames_equal_eager_frames(cuda):
    """The tiny server pair on the card: 20 frames and then two scans of 4
    through the captured graphs (the frame and the scan share the state
    buffers) equal the eager frames and scans bit for bit; a ``reset``
    reuses the graphs, and the next session equals the first."""
    import numpy as np

    pcm = np.random.default_rng(1).normal(0, 0.1, (28, 1920)).astype(np.float32)
    runs = []
    for graphs in (False, True, True):
        state = runs[-1][0] if len(runs) == 2 else _card_state(graphs=graphs)
        state.reset()
        got = [state.handle_frame_array(p) for p in pcm[:20]]
        got += [state.handle_frames_array(pcm[i : i + 4].reshape(-1)) for i in (20, 24)]
        runs.append((state, got))
    graph_state = runs[1][0]
    assert set(graph_state.graphs()) == {"frame", "scan_4"}
    assert all(g.captures == 1 for g in graph_state.graphs().values())
    for _, got in runs[1:]:
        for (a0, t0), (a1, t1) in zip(runs[0][1], got):
            assert t0 == t1
            if a0 is not None:
                np.testing.assert_array_equal(a0, a1)


def test_graph_is_recaptured_after_weights_are_replaced(cuda):
    """``quantize_for_serving`` replaces the LM's weights: the next frame
    does not replay the graph captured over the old ones (it warms up and
    captures again), and its frames equal an eager state's over the
    quantized weights."""
    import numpy as np

    from rstnet_tpu_torch.serving.server import quantize_for_serving

    pcm = np.random.default_rng(2).normal(0, 0.1, (6, 1920)).astype(np.float32)
    state = _card_state(scan_frames=0)
    for p in pcm[:3]:
        state.handle_frame_array(p)
    graph = state.graphs()["frame"]
    assert graph.captures == 1
    quantize_for_serving(state.lm_gen.model, int8=True)
    eager = _card_state(scan_frames=0, graphs=False)
    eager.mimi, eager.lm_gen = state.mimi, state.lm_gen
    state.reset()
    eager.reset()
    for p in pcm:
        (a0, t0), (a1, t1) = eager.handle_frame_array(p), state.handle_frame_array(p)
        assert t0 == t1
        if a0 is not None:
            np.testing.assert_array_equal(a0, a1)
    assert graph.captures == 2


def test_batched_tick_graph_equals_eager_tick(cuda):
    """Two sessions of the tiny pair through ``SessionBatcher``: the
    replayed tick's frames equal the eager tick's, with a join between
    replays (the slot reset runs in place on the captured buffers)."""
    import numpy as np

    frames = np.random.default_rng(3).normal(0, 0.1, (8, 1920)).astype(np.float32)
    streams = []
    for graphs in (False, True):
        b = _card_batcher(cuda_graphs=graphs)
        first = b.acquire()
        second = None
        for i, f in enumerate(frames):
            if i == 4:
                second = b.acquire()
            for sess in (first, second):
                if sess is not None:
                    sess.inputs.put_nowait(f)
            b.step_once()
        assert (b._graph is not None and b._graph.captures == 1) == graphs
        streams.append([[s.outputs.get_nowait() for _ in range(s.outputs.qsize())]
                        for s in (first, second)])
    for got0, got1 in zip(*streams):
        assert len(got0) == len(got1) > 0
        for (a0, t0), (a1, t1) in zip(got0, got1):
            assert t0 == t1
            np.testing.assert_array_equal(a0, a1)


def test_sampling_graph_draws_fresh_noise_and_repeats_from_its_seed(cuda):
    """With sampling on, the captured frame draws from the state's
    generator (registered with the graph): a second session after
    ``reset`` (which re-seeds the same generator in place) repeats the
    first session's tokens, a state with another seed does not, and the
    replays do not repeat one draw (the text tokens vary over the frames)."""
    import numpy as np

    from rstnet_tpu_torch.serving.server import ServerState, build_models

    mimi, gen = build_models(True, torch.device("cuda"), 0)
    pcm = np.random.default_rng(4).normal(0, 0.1, (12, 1920)).astype(np.float32)

    def session(state):
        state.reset()
        return [state.handle_frame_array(p)[1] for p in pcm]

    state = ServerState(mimi, gen, seed=5)
    first, second = session(state), session(state)
    other = session(ServerState(mimi, gen, seed=6))
    assert state.graphs()["frame"].captures == 1
    assert first == second and first != other and len(set(first)) > 1


def test_k1_over_float32_weights_in_graphs(cuda):
    """A float32 Moshi inside K1's envelope (a converted checkpoint's dtype)
    with the tiny Mimi: graph frames equal eager frames bit for bit, K1
    reading one bf16 rounding of the depformer stacks; a weight written in
    place recaptures the graph (``weights_key``), and the frames after
    equal an eager state's over the written weights."""
    import numpy as np

    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands
    from rstnet_tpu_torch.serving.server import ServerState, build_models

    mimi, _ = build_models(True, torch.device("cuda"), 0)
    lm = MoshiLMModel(delays=(0, 0) + (1,) * 7 + (0,) + (1,) * 7, n_q=16, dep_q=8, card=128,
                      text_card=256, dim=64, num_heads=4, num_layers=2, hidden_scale=4.0,
                      context=64, depformer_dim=128, depformer_dim_feedforward=192,
                      depformer_num_heads=2, depformer_num_layers=2, device="cuda",
                      generator=cuda)
    gen = LMGen(lm, delays=lm.delays, use_sampling=False)
    ops = depformer_kernel_operands(lm)
    assert ops is not None and ops["in_proj"].dtype == torch.bfloat16
    assert depformer_kernel_operands(lm)["in_proj"].data_ptr() == ops["in_proj"].data_ptr()
    pcm = np.random.default_rng(4).normal(0, 0.1, (6, 1920)).astype(np.float32)
    graph, eager = (ServerState(mimi, gen, cuda_graphs=g) for g in (True, False))
    for written in (False, True):
        if written:
            with torch.no_grad():
                lm.depformer.layers.in_proj.mul_(1.5)
            graph.reset()
            eager.reset()
        for p in pcm:
            (a0, t0), (a1, t1) = eager.handle_frame_array(p), graph.handle_frame_array(p)
            assert t0 == t1
            if a0 is not None:
                np.testing.assert_array_equal(a0, a1)
    assert graph.graphs()["frame"].captures == 2
    torch.testing.assert_close(depformer_kernel_operands(lm)["in_proj"],
                               lm.depformer.layers.in_proj.to(torch.bfloat16), rtol=0, atol=0)


def test_glm4v_flow_cuda_graph_matches_eager_and_cpu(cuda):
    """The flow's Euler solve with its U-Net as a CUDA graph (the card's
    default) against the same solve eager on the card (1e-5: the same
    kernels, the first call on the capture stream), and the whole
    ``GLM4VFlow.inference`` on the card against the CPU (1e-3,
    ``chip_smoke.SSL_MEL_TOL``) and bit for bit across two calls."""
    import copy

    from rstnet_tpu_torch.models.glm4v_flow import (
        ConformerConfig,
        GLM4VFlow,
        GLM4VFlowConfig,
        UNetConfig,
        cfm_solve,
    )

    cfg = GLM4VFlowConfig(
        vocab_size=64, input_size=32, encoder=ConformerConfig(
            input_size=32, output_size=32, attention_heads=2, linear_units=64, num_blocks=1),
        unet=UNetConfig(channels=(32, 32), attention_head_dim=16, n_blocks=1, num_mid_blocks=1,
                        num_heads=2), n_timesteps=4)
    flow = GLM4VFlow(cfg, generator=torch.Generator().manual_seed(0))
    token = torch.randint(0, 64, (1, 13), generator=torch.Generator().manual_seed(1))
    T = cfg.mel_len(13)
    z = torch.randn(1, T, 80, generator=torch.Generator().manual_seed(2))
    want = flow.inference(token, z)
    card = copy.deepcopy(flow).cuda()
    graphed = card.inference(token.cuda(), z.cuda())
    assert torch.equal(graphed, card.inference(token.cuda(), z.cuda()))
    assert (graphed.cpu() - want).abs().max().item() <= 1e-3
    g = torch.Generator().manual_seed(3)
    z, mu, cond = (torch.randn(1, T, 80, generator=g).cuda() for _ in range(3))
    spks, mask = torch.randn(1, 80, generator=g).cuda(), torch.ones(1, T, device="cuda")
    with torch.no_grad():
        solves = [cfm_solve(card.unet, z, mu, mask, spks, cond, n_timesteps=4, cuda_graph=graph)
                  for graph in (True, False)]
    assert (solves[0] - solves[1]).abs().max().item() <= 1e-5
