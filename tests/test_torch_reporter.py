"""The port's training reporter (``rstnet_tpu_torch/utils/reporter.py``, a
copy of ``rstnet_tpu/utils/reporter.py``), mirroring
``tests/test_trainer.py::test_reporter`` and
``::test_subreporter_windows_and_timers``, each also held to the JAX
reporter fed the same values: equal epochs, statistics, messages and
state."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

from rstnet_tpu.utils.reporter import Reporter as JaxReporter
from rstnet_tpu_torch.utils.reporter import Reporter


def _fill(r):
    for ep in (1, 2, 3):
        r.set_epoch(ep)
        with r.observe("train") as sub:
            for i in range(4):
                sub.register({"loss": 10.0 / ep + i * 0.1})
                sub.next()
        with r.observe("valid") as sub:
            sub.register({"loss": 5.0 / ep})
            sub.next()
    return r


def test_reporter():
    r, j = _fill(Reporter()), _fill(JaxReporter())
    assert r.best_epoch("valid", "loss", "min") == 3
    assert not r.check_early_stopping(2, "valid", "loss")
    msg = r.log_message()
    assert "train" in msg and "valid" in msg
    assert msg == j.log_message()
    assert r.stats == j.stats
    assert r.state_dict() == j.state_dict()
    for mode in ("min", "max"):
        assert r.best_epoch("train", "loss", mode) == j.best_epoch("train", "loss", mode)
    # state roundtrip
    r2 = Reporter()
    r2.load_state_dict(r.state_dict())
    assert r2.get_epoch() == 3
    assert r2.best_epoch("valid", "loss") == 3


def test_subreporter_windows_and_timers():
    msgs, stats = [], []
    for cls in (Reporter, JaxReporter):
        r = cls()
        with r.observe("train", epoch=1) as sub:
            with sub.measure_time("fwd"):
                pass
            for item in sub.measure_iter_time(range(3), "iter_time"):
                sub.register({"x": item})
                sub.next()
            msg = sub.log_message(-2)
            assert "x=" in msg
            msgs.append(msg.split("x=")[1].split(",")[0])
        assert "x" in r.stats[1]["train"]
        stats.append(r.stats[1]["train"]["x"])
    assert msgs[0] == msgs[1] and stats[0] == stats[1]
