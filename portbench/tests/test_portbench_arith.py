"""The yardstick's arithmetic: percentiles and rates over every sample, and
the byte and operation counts of K1-int8, K2, K3 and a whole step against
sums worked by hand from Moshi 7B's and Mimi's shapes."""

from __future__ import annotations

import json
import math
import types
from pathlib import Path

import pytest

from portbench.lib import counts
from portbench.lib.manifest import reader
from portbench.lib.stats import percentile, rate
from portbench.reference import layout

ROOT = Path(__file__).resolve().parents[2]


def _z(name="moshiko_bf16"):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    return cfg, layout.derived(cfg)


def test_percentile_and_rate_take_every_sample():
    samples = [float(v) for v in range(1, 101)]  # 1..100
    assert percentile(samples, 0.95) == 96.0  # index int(100 * 0.95) = 95
    assert percentile(samples[::-1], 0.5) == 51.0  # unsorted input, every sample
    assert percentile([7.0], 0.95) == 7.0
    assert percentile(samples + [1000.0, 1000.0, 1000.0, 1000.0, 1000.0, 1000.0], 0.95) == 1000.0
    assert rate(16 * 460, 30.0) == pytest.approx(245.3333333)
    with pytest.raises(ValueError):
        percentile([], 0.5)


def test_derived_sizes():
    _, z = _z()
    assert (z["hidden"], z["dep_hidden"], z["n_text"]) == (11264, 2816, 32000)
    assert (z["hop"], z["resample"], max(z["delays"])) == (960, 2, 1)


def test_k1_int8_counts():
    _, z = _z("moshiko_q8")
    C, H, L = 1024, 2816, 6
    per_layer = (3 * C * C + 4 * 3 * C) + (C * C + 4 * C) + (2 * H * C + 4 * 2 * H) + (C * H + 4 * C)
    head = 2048 * C + 4 * 2048
    cb = 3
    kv = L * 2 * C * (cb + 2) * 4  # float32 cache: steps 0..cb read, step cb written
    nbytes = L * per_layer + head + 2 * L * C * 4 + kv + 2 * C + 4 * 2048
    flops = 2 * (L * (3 * C * C + C * C + 2 * H * C + C * H) + 2048 * C) + L * 4 * C * (cb + 1)
    assert counts.k1_call(z, cb, True, "float32", "int8") == (nbytes, flops)
    # the bound PERF.md gives for K1-int8 at Moshi's shape: 0.0238 ms
    assert counts.bound_s(*counts.k1_call(z, 0, True, "float32", "int8"), "bf16") == \
        pytest.approx(23.76e-6, rel=2e-3)


def test_k2_counts():
    _, z = _z()
    assert counts.k2_call(z, 16, "bfloat16", "bfloat16") == (
        3 * 2816 * 1024 * 2 + 2 * 16 * 1024 * 2, 2 * 16 * 3 * 2816 * 1024)
    assert counts.bound_s(*counts.k2_call(z, 16, "bfloat16", "bfloat16"), "bf16") == \
        pytest.approx(17367040 / 3.35e12)


def test_k3_counts():
    _, z = _z()
    nbytes, flops = counts.k3_call(z, 16, 7)
    assert nbytes == 16 * 256 * 4 + 7 * 2048 * 256 * 4 + 16 * 7 * 4 + 16 * 256 * 4
    assert flops == 2 * 16 * 7 * 2048 * 256
    assert counts.k3_unit(16) == "f32" and counts.k3_unit(65) == "tf32"


def test_step_counts_against_the_layout():
    """A step's bytes from the layout's tensors: every matrix once, embedding
    tables only at the rows looked up, Mimi's used codebook levels, rings at
    the held positions."""
    cfg, z = _z()
    pos = 100
    spec = {name: shape for name, shape, *_ in layout.spec(cfg)}
    numel = lambda name: math.prod(spec[name])  # noqa: E731
    tables = ("lm.emb", "lm.text_emb", "lm.depformer_emb", "lm.depformer_text_emb")
    lm = sum(numel(n) * (4 if n.endswith("alpha") else 2)
             for n in spec if n.startswith("lm.") and n not in tables)
    rows = 16 * (17 * 4096 + 8 * 1024) * 2
    ring = 16 * 32 * 2 * 4096 * 2 * pos
    unused = ("embedding_sum", "cluster_usage", "initialized", "norm", "layer_scale")
    mimi = sum(numel(n) for n in spec if n.startswith("mimi.") and not any(u in n for u in unused))
    mimi += 8 * 2048 * 256  # the centroids of the used levels
    mimi_ring = 16 * 2 * 8 * 2 * 512 * min(2 * pos, 250) * 4
    nbytes, flops = counts.step(z, cfg, 16, pos, 2 * 4096 * 2)
    assert nbytes == pytest.approx(lm + rows + ring + 4 * mimi + mimi_ring, rel=1e-9)
    matmul = sum(numel(n) for n in spec if n.startswith("lm.") and n not in tables
                 and not n.endswith("alpha"))
    assert flops >= 2 * 16 * matmul + 16 * 32 * 4 * 4096 * pos
    weights, _ = counts.step(z, cfg, 1, 0, 2 * 4096 * 2)
    assert 14.9e9 < weights < 15.3e9  # 14.7 GB of bf16 weights, 0.38 GB of Mimi in float32
    # the ring holds the context at most; Mimi's transformers their own
    full = counts.step(z, cfg, 16, 3000, 2 * 4096 * 2)
    assert counts.step(z, cfg, 16, 4000, 2 * 4096 * 2) == full
    assert full[0] - nbytes == pytest.approx(16 * 32 * 2 * 4096 * 2 * 2900
                                             + 16 * 2 * 8 * 2 * 512 * (250 - 200) * 4)


@pytest.mark.parametrize("kv_int8,dtype,stacked,per_pos", [
    (False, "bfloat16", False, 2 * 64 * 2), (False, "float32", False, 2 * 64 * 4),
    (True, "float32", False, 2 * 64 + 2 * 4 * 2), (False, "bfloat16", True, 2 * 64 * 2)])
def test_ring_bytes_from_the_programs_state(kv_int8, dtype, stacked, per_pos):
    """A position of a session in a layer: keys and values, and the int8
    ring's bf16 scale a head, read from the program's own ring buffers."""
    import torch

    from portbench.lib.serve import Driver
    from rstnet_tpu_torch.ops.attention import ring_kv_buffers

    shape = (3, 4, 10, 16)  # [sessions, heads, capacity, head dim]: 64 wide
    dt = getattr(torch, dtype)
    kv = ring_kv_buffers((5, *shape), dt, "cpu", kv_int8) if stacked else \
        [ring_kv_buffers(shape, dt, "cpu", kv_int8) for _ in range(5)]
    server = types.SimpleNamespace(lm_state={"lm": {"kv": kv}})
    assert Driver.ring_bytes(types.SimpleNamespace(server=server)) == per_pos


def test_step_shares_read_the_traced_steps():
    """``step_hbm_share`` and ``step_mfu``: the counts at each traced step's
    own positions over the device's busy time in the traced window."""
    cfg, z = _z()
    events = [("a", 0.0, 1000.0), ("b", 500.0, 3000.0), ("c", 5000.0, 6000.0)]  # busy 4 ms
    run = types.SimpleNamespace(cfg=cfg, z=z, counts=counts, sessions=16, events=events,
                                traced_positions=[300, 301], ring_bytes=2 * 4096 * 2)
    steps = [counts.step(z, cfg, 16, p, 2 * 4096 * 2) for p in (300, 301)]
    hbm = reader(ROOT, "step_hbm_share")(run)
    assert hbm == pytest.approx(100 * sum(b for b, _ in steps) / (3.35e12 * 0.004))
    mfu = reader(ROOT, "step_mfu")(run)
    assert mfu == pytest.approx(100 * sum(f for _, f in steps) / (989e12 * 0.004))
    assert reader(ROOT, "step_mfu")(types.SimpleNamespace(**dict(vars(run), events=[]))) is None
