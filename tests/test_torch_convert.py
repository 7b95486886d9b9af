"""The port's checkpoint converter (``rstnet_tpu_torch/models/convert.py``)
and its CLI against the JAX package's, on tiny upstream-layout files.

The upstream files are written from seeded port models by
``tools/upstream_layout.py`` (its writer for ``.safetensors``, ``torch.save``
for ``.pt``). Both converters read the same file (JAX reads bf16 weights
from a ``.pt`` of the same tensors: its ``safetensors.numpy`` reader keeps
bf16 where its ``.pt`` branch widens), and their trees must be equal key for
key and bit for bit: the converters only rename, slice and stack. Forwards
of the converted models are held to the float32 tolerance of the port's
other parity tests (1e-5 here, small modules), and greedy tokens must be
equal."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict as jax_flatten
from rstnet_tpu.models import convert as jc
from rstnet_tpu_torch.core import flatten_dict
from rstnet_tpu_torch.models import convert as tc
from rstnet_tpu_torch.tools import upstream_layout as ul
from tests.test_convert_cli import CFG_YAML, _lit_state_dict
from tests.test_torch_moshi import MOSHI
from tests.test_torch_speech_lm import CFG as SPEECH_CFG

MIMI = dict(n_q_total=8, dimension=64, n_filters=8, num_layers=2, quantizer_dim=32, bins=64)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy_sd(sd):
    """The JAX converter's input: the file's tensors as numpy (float32)."""
    return {k: v.numpy() for k, v in sd.items()}


def assert_trees_equal(port_tree, jax_tree):
    got = dict(flatten_dict(port_tree))
    want = {k: np.asarray(v) for k, v in jax_flatten(jax_tree)}
    assert list(got) == list(want)
    for k, v in got.items():
        a = v.numpy()
        assert a.dtype == want[k].dtype and a.shape == want[k].shape, k
        assert a.tobytes() == want[k].tobytes(), k


def _tiny_mimi(seed=0):
    """The server's --tiny Mimi with random codebooks (the default init
    leaves every codebook at zero)."""
    from rstnet_tpu_torch.models.mimi import mimi_24k

    g = torch.Generator().manual_seed(seed)
    m = mimi_24k(**MIMI, generator=g)
    for rvq in (m.quantizer.rvq_first, m.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)
    return m


@pytest.mark.parametrize("naming", ul.CONV_NAMINGS)
def test_mimi_converter_matches_jax(tmp_path, naming):
    """Each of the three upstream conv namings: the trees are equal, and the
    converted models encode to equal codes."""
    from rstnet_tpu.models.mimi import mimi_24k as jax_mimi
    from rstnet_tpu_torch.models.mimi import mimi_24k

    path = ul.write_upstream(tmp_path / "mimi.safetensors", ul.upstream_mimi(_tiny_mimi(), naming))
    sd = tc.load_torch_state_dict(path)
    assert any(k.endswith("weight_g") or k.endswith("original0") for k in sd) == (
        naming != "plain")
    tm = mimi_24k(**MIMI, generator=torch.Generator().manual_seed(9))
    tree = tc.convert_mimi(sd, tm)
    jm = jax_mimi(**MIMI)
    jtree = jc.convert_mimi(_numpy_sd(sd), jm)
    assert_trees_equal(tree, jtree)
    assert tc.load_mimi(path, tm) is tm
    x = np.random.default_rng(1).normal(0, 0.1, (1, 1, 3 * 1920)).astype(np.float32)
    codes = tm.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jax.jit(jm.encode)(jtree, x)))
    assert len(np.unique(codes.numpy())) > 1


@pytest.mark.parametrize("bias,multi_linear", [(False, True), (True, True), (False, False),
                                               (True, False)])
def test_moshi_converter_matches_jax(tmp_path, bias, multi_linear):
    """Moshi with and without ``linears.*.bias`` (and ``text_linear.bias``)
    and ``depformer_multi_linear``, from a ``{"model": ...}`` ``.pt``; the
    port's module takes the file's biases whatever it was built with."""
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    cfg = dict(MOSHI, depformer_multi_linear=multi_linear)
    src = MoshiLMModel(**cfg, bias_proj=bias, generator=torch.Generator().manual_seed(2))
    if bias:
        for b in (src.linears.bias, src.text_linear.bias):
            b.normal_(generator=torch.Generator().manual_seed(3))
    path = ul.write_upstream(tmp_path / "moshi.pt", ul.upstream_moshi(src), wrap=True)
    sd = tc.load_torch_state_dict(path)
    assert ("linears.0.bias" in sd) == bias
    tm = MoshiLMModel(**cfg, generator=torch.Generator().manual_seed(4))
    tree = tc.convert_moshi_lm(sd, tm)
    assert_trees_equal(tree, jc.convert_moshi_lm(_numpy_sd(sd), JM(**cfg)))
    tc.load_converted(tree, tm)
    for name, want in src.state_dict().items():
        assert torch.equal(tm.state_dict()[name], want), name


@pytest.mark.parametrize("mlp,norm,bias", [("LLaMAMLP", "RMSNorm", False),
                                           ("GptNeoxMLP", "LayerNorm", True)])
def test_backbone_converter_matches_jax(tmp_path, mlp, norm, bias):
    from rstnet_tpu.models.backbone import Backbone as JB
    from rstnet_tpu.models.config import Config as JaxConfig
    from rstnet_tpu_torch.models.backbone import STACKED, Backbone
    from rstnet_tpu_torch.models.config import Config

    d = dict(name="t", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2, n_head=2,
             n_embd=16, n_query_groups=1, rotary_percentage=1.0, parallel_residual=False,
             bias=bias, norm_class_name=norm, mlp_class_name=mlp, intermediate_size=32)
    src = Backbone(Config(**d), generator=torch.Generator().manual_seed(5))
    path = ul.write_upstream(tmp_path / "lit_model.pth", ul.upstream_backbone(src))
    sd = tc.load_torch_state_dict(path)
    tree = tc.convert_backbone(sd, Config(**d))
    jtree = jc.convert_backbone(_numpy_sd(sd), JaxConfig(**d))
    assert_trees_equal(tree, jtree)
    tb = tc.load_backbone(path, Backbone(Config(**d), generator=torch.Generator().manual_seed(6)))
    for name, want in src.state_dict().items():
        assert torch.equal(tb.state_dict()[name], want), name
    assert STACKED == ("blocks",)
    tokens = np.random.default_rng(0).integers(0, 96, (1, 8))
    np.testing.assert_allclose(
        tb.forward_tokens(torch.from_numpy(tokens)).detach().numpy(),
        np.asarray(JB(JaxConfig(**d)).forward_tokens(jtree, jnp.asarray(tokens))), **FWD_TOL)


@pytest.mark.parametrize("norm_emb,bias_proj", [(False, False), (True, False), (False, True),
                                                (True, True)])
def test_speech_lm_converter_matches_jax(tmp_path, norm_emb, bias_proj):
    from rstnet_tpu.models.config import Config as JaxConfig
    from rstnet_tpu.models.lm import SpeechTextLM as JaxLM
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM

    d = dict(SPEECH_CFG, codecformer_norm_emb=norm_emb, codecformer_bias_proj=bias_proj)
    src = SpeechTextLM(Config(**d), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        for p in src.parameters():  # norms and biases away from their 1/0 init
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(8)))
    path = ul.write_upstream(tmp_path / "flagship.safetensors", ul.upstream_speech_lm(src))
    sd = tc.load_torch_state_dict(path)
    tm = SpeechTextLM(Config(**d), generator=torch.Generator().manual_seed(9))
    tree = tc.convert_speech_lm(sd, tm)
    assert_trees_equal(tree, jc.convert_speech_lm(_numpy_sd(sd), JaxLM(JaxConfig(**d))))
    tc.load_converted(tree, tm, stacked=tm.STACKED)
    for name, want in src.state_dict().items():
        assert torch.equal(tm.state_dict()[name], want), name


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a.weight": torch.randn(5, 3, generator=g),
            "b.weight": torch.randn(7, generator=g).to(torch.bfloat16),
            "c.half": torch.randn(2, 2, generator=g).half(),
            "d.count": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "e.flag": torch.tensor([True, False])}


@pytest.mark.parametrize("form", ["pt", "pt_model", "safetensors_f32", "safetensors_bf16"])
def test_load_torch_state_dict(tmp_path, form):
    """``.pt`` bare and under ``{"model": ...}`` against the JAX loader;
    float32 ``.safetensors`` against the ``safetensors`` package; bf16
    ``.safetensors`` against the ``.pt`` of the same tensors (the JAX loader
    keeps that file's bf16). Float tensors come out float32, others as
    stored."""
    t = _tensors()
    if form.startswith("pt"):
        path = ul.write_upstream(tmp_path / "x.pt", t, wrap=form == "pt_model")
        got = tc.load_torch_state_dict(path)
        want = jc.load_torch_state_dict(str(path))
        assert sorted(got) == sorted(want)
        for k in t:
            if t[k].is_floating_point():
                assert got[k].dtype == torch.float32
                assert got[k].numpy().tobytes() == want[k].tobytes(), k
            else:
                assert got[k].dtype == t[k].dtype and torch.equal(got[k], t[k]), k
        return
    if form == "safetensors_f32":
        from safetensors.torch import load_file

        f32 = {k: v.float() if v.is_floating_point() else v for k, v in t.items()}
        path = ul.write_upstream(tmp_path / "x.safetensors", f32)
        want = load_file(str(path))
        got = tc.load_torch_state_dict(path)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        return
    bf16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in t.items()}
    path = ul.write_upstream(tmp_path / "x.safetensors", bf16)
    # the deliberate difference: the JAX loader keeps bf16 (with ml_dtypes
    # loaded, else it raises); the port widens it, as the .pt branch does
    jax_sft = jc.load_torch_state_dict(str(path))
    assert jax_sft["b.weight"].dtype.name == "bfloat16"
    got = tc.load_torch_state_dict(path)
    want = tc.load_torch_state_dict(ul.write_upstream(tmp_path / "x.pt", bf16))
    jax_pt = jc.load_torch_state_dict(str(tmp_path / "x.pt"))
    for k in bf16:
        assert got.raw(k).dtype == bf16[k].dtype and torch.equal(got[k], want[k]), k
        if bf16[k].is_floating_point():
            assert got[k].dtype == torch.float32 and got[k].numpy().tobytes() == jax_pt[k].tobytes()
            assert got[k].numpy().tobytes() == jax_sft[k].astype(np.float32).tobytes()


@pytest.mark.parametrize("fmt", ["npz", "torch"])
def test_backbone_convert_cli_matches_jax(tmp_path, fmt):
    """Mirror of ``tests/test_convert_cli.py::test_backbone_convert_roundtrip``:
    the port's ``npz`` equals the JAX CLI's key for key and byte for byte;
    its default format loads into ``Backbone``, whose forward equals JAX's."""
    from rstnet_tpu.models.backbone import Backbone as JB
    from rstnet_tpu.models.config import Config as JaxConfig
    from rstnet_tpu.tools import convert_checkpoint as jax_cli
    from rstnet_tpu_torch.models.backbone import Backbone
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.tools import convert_checkpoint
    from rstnet_tpu_torch.training.checkpoint import restore_checkpoint

    sd = _lit_state_dict(torch.Generator().manual_seed(0))
    ckpt = tmp_path / "lit_model.pth"
    torch.save(sd, str(ckpt))
    cfg_path = tmp_path / "model.yaml"
    cfg_path.write_text(CFG_YAML)
    common = ["--kind", "backbone", "--input", str(ckpt), "--model_config", str(cfg_path)]
    jax_cli.main([*common, "--output", str(tmp_path / "jax"), "--format", "npz"])
    want = np.load(tmp_path / "jax.npz")
    if fmt == "npz":
        convert_checkpoint.main([*common, "--output", str(tmp_path / "port"), "--format", "npz"])
        got = np.load(tmp_path / "port.npz")
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        np.testing.assert_array_equal(got["wte"], sd["transformer.wte.weight"].numpy())
        return
    out = tmp_path / "converted"
    convert_checkpoint.main([*common, "--output", str(out)])
    bb = Backbone(Config.from_file(str(cfg_path)))
    restore_checkpoint(out, {"model": bb}, partial=True)
    assert torch.equal(bb.wte, sd["transformer.wte.weight"])
    jparams = jc.convert_backbone(jc.load_torch_state_dict(str(ckpt)),
                                  JaxConfig.from_file(str(cfg_path)))
    tokens = np.random.default_rng(1).integers(0, 96, (1, 8))
    logits = bb.forward_tokens(torch.from_numpy(tokens)).detach().numpy()
    assert logits.shape == (1, 8, 96) and np.isfinite(logits).all()
    jlogits = JB(JaxConfig.from_file(str(cfg_path))).forward_tokens(jparams, jnp.asarray(tokens))
    np.testing.assert_allclose(logits, np.asarray(jlogits), **FWD_TOL)


def test_converted_moshi_frames_match_jax(tmp_path, monkeypatch):
    """A tiny Moshi written in bf16 and converted by each side (float32
    weights, as the JAX server serves a converted checkpoint): four greedy
    ``LMGen.step`` frames at B=1 give equal tokens. JAX runs K1's Pallas
    kernel in interpret mode, which rounds each weight to bf16 as it reads
    it; the port runs K1's plain version on the bf16 rounding of the float32
    stacks (``bf16_rounding``), taken once and reused frame to frame."""
    import rstnet_tpu_torch.inference.generate as gen_mod
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    monkeypatch.setenv("RSTNET_PALLAS_DEP", "interpret")
    src = MoshiLMModel(**MOSHI, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(1))
    up = ul.upstream_moshi(src)
    path = ul.write_upstream(tmp_path / "moshi.safetensors", up)
    tm = tc.load_moshi_lm(path, MoshiLMModel(**MOSHI, generator=torch.Generator().manual_seed(2)))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    jm = JM(**MOSHI)
    jparams = jc.convert_moshi_lm(jc.load_torch_state_dict(
        str(ul.write_upstream(tmp_path / "moshi.pt", up))), jm)
    assert_trees_equal(tc.convert_moshi_lm(tc.load_torch_state_dict(path), tm), jparams)

    stacks = []
    real = gen_mod.depformer_step

    def spy(x, cb, norm1, in_proj, *args, **kwargs):
        stacks.append(in_proj)
        return real(x, cb, norm1, in_proj, *args, **kwargs)

    monkeypatch.setattr(gen_mod, "depformer_step", spy)
    user = np.random.default_rng(4).integers(0, 128, (4, 1, 8, 1))
    jgen = JGen(jm, delays=jm.delays, use_sampling=False, kv_unstacked=True)
    tgen = LMGen(tm, delays=tm.delays, use_sampling=False)
    jst, tst = jgen.init_state(1, jnp.float32), tgen.init_state(1, torch.float32)
    step = jax.jit(jgen.step)
    for t in range(4):
        jo, jv, jst = step(jparams, jst, jax.random.PRNGKey(0), jnp.asarray(user[t]))
        to, tv, tst = tgen.step(tst, None, torch.from_numpy(user[t]))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert len(stacks) == 4 * 8  # K1 at every micro-step
    rounded = tm.depformer.layers.in_proj.to(torch.bfloat16)
    assert all(s.dtype == torch.bfloat16 and torch.equal(s, rounded) for s in stacks)
    assert len({s.data_ptr() for s in stacks}) == 1  # one copy, taken at the first frame


def test_server_checkpoint_flags_and_tiny(tmp_path):
    """The server takes the JAX server's checkpoint flags; ``--tiny``
    ignores them (it reads none of the files), as in JAX."""
    from rstnet_tpu_torch.serving.server import build_server, parse_args

    missing = str(tmp_path / "absent")
    args = parse_args(["--tiny", "--device", "cpu", "--mimi-checkpoint", missing,
                       "--lm-checkpoint", missing, "--tokenizer-dir", missing])
    assert (args.mimi_checkpoint, args.lm_checkpoint, args.tokenizer_dir) == (missing,) * 3
    state = build_server(args)
    assert state.text_tokenizer is None and state.steps == 0
    assert all(p.dtype == torch.float32 for p in state.lm_gen.model.parameters())


def test_bf16_rounding_is_kept_until_the_weight_changes():
    """K1's operands over float32 stacks: their bf16 rounding, one copy
    reused call after call, taken anew after an in-place write or a
    replaced weight; bf16 and int8 stacks pass through as before."""
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.ops.cuda_depformer import bf16_rounding, depformer_kernel_operands

    tm = MoshiLMModel(**MOSHI, generator=torch.Generator().manual_seed(0))
    first = depformer_kernel_operands(tm)
    again = depformer_kernel_operands(tm)
    for name in ("in_proj", "out_proj", "gin", "gout", "head_w"):
        assert first[name].dtype == torch.bfloat16
        assert first[name].data_ptr() == again[name].data_ptr(), name
    assert torch.equal(first["gin"], tm.depformer.layers.gating.linear_in.to(torch.bfloat16))
    with torch.no_grad():
        tm.depformer.layers.gating.linear_in.mul_(2.0)
    after = depformer_kernel_operands(tm)
    assert torch.equal(after["gin"], tm.depformer.layers.gating.linear_in.to(torch.bfloat16))
    assert after["in_proj"].data_ptr() == first["in_proj"].data_ptr()
    tm.linears.weight = torch.nn.Parameter(tm.linears.weight.detach().clone(),
                                           requires_grad=False)
    assert depformer_kernel_operands(tm)["head_w"].data_ptr() != first["head_w"].data_ptr()
    bf = torch.ones(3, dtype=torch.bfloat16)
    assert bf16_rounding(bf) is bf
