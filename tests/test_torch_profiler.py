"""The port's profiler (``mxnet_tpu_torch/profiler.py``) against the JAX
package's: the configuration surface, the Chrome-trace events of the
instrumentation objects (``Domain`` / ``Task`` / ``Frame`` / ``Event`` /
``Counter`` / ``Marker``) and of ``scope``, the aggregate table of
``dumps`` on the same recorded slices (equal text), and a pipelined
two-step ``TrainLoop`` whose dump holds both the ops of the funnel
(phase-tagged ``dispatch``) and the telemetry's step spans (``cat:
"step"``) in one stream. The device trace (``tensorboard_dir``) runs
``torch.profiler`` here on the CPU.
"""
import json
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop as TTrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.ops.kernels import norm


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    """A stopped, empty profiler and zeroed telemetry around each test."""
    from mxnet_tpu import profiler as jprof
    for p in (tprof, jprof):
        p.set_state("stop")
        p.Profiler.get()._events.clear()
        p.set_config(filename=str(tmp_path / "profile.json"),
                     tensorboard_dir=None)
    ttel.reset()
    yield
    for p in (tprof, jprof):
        p.set_state("stop")
        p.resume()
        p.Profiler.get()._events.clear()
    ttel.reset()


def test_config_surface_and_state():
    with pytest.raises(mxt.MXNetError):
        tprof.set_config(bogus=1)
    with pytest.raises(mxt.MXNetError):
        tprof.set_state("pause")
    tprof.set_config(profile_all=True, aggregate_stats=True)
    assert tprof.state() == "stop"
    tprof.set_state("run")
    assert tprof.state() == "run"
    tprof.set_state("stop")
    assert tprof.state() == "stop"


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}


def test_instrumentation_objects_emit_the_jax_events():
    from mxnet_tpu import profiler as jprof
    streams = []
    for p in (jprof, tprof):
        p.set_state("run")
        d = p.Domain("train")
        with d.new_task("fwd"):
            pass
        with d.new_frame("frame0"):
            pass
        with p.Event("evt"):
            pass
        c = d.new_counter("items", 3)
        c += 2
        c -= 1
        d.new_marker("here").mark("thread")
        with p.scope("outer"):
            p.Profiler.get().record("op", 1.0, 2.0)
        p.pause()
        p.Profiler.get().record("dropped", 1.0, 2.0)
        p.resume()
        p.set_state("stop")
        streams.append([_strip(e) for e in p.Profiler.get()._events])
    assert streams[1] == streams[0]
    with pytest.raises(mxt.MXNetError):
        tprof.Task(tprof.Domain("d"), "t").stop()


def test_dumps_table_equals_jax_on_the_same_slices():
    from mxnet_tpu import profiler as jprof
    slices = [("fully_connected", 0.0, 0.003), ("layer_norm", 0.0, 0.001),
              ("fully_connected", 1.0, 1.005), ("flash_attention", 0, .01)]
    for p in (jprof, tprof):
        p.set_state("run")
        for name, t0, t1 in slices:
            p.Profiler.get().record(name, t0, t1)
    assert tprof.dumps() == jprof.dumps()
    assert tprof.dumps(reset=True).splitlines()[1].startswith(
        "flash_attention")
    assert len(tprof.dumps().splitlines()) == 1


def test_chrome_trace_merges_op_events_and_step_spans(tmp_path):
    """Two pipelined steps under the profiler (no MXNET_TELEMETRY: a
    running profiler turns the step spans on): the dump holds the ops the
    funnel saw, each tagged with its dispatch phase, and the dispatch /
    window / retire spans of both steps."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(Dense(8, in_units=4, activation="relu",
                                    device="cpu"),
                              Dense(3, in_units=8, device="cpu"))
    loop = TTrainLoop(net, TTrainer(dict(net.named_parameters()), "sgd",
                                    {"learning_rate": 0.1}),
                      tloss.SoftmaxCrossEntropyLoss(), inflight=1)
    r = onp.random.RandomState(0)
    x = torch.from_numpy(r.randn(8, 4).astype("f4"))
    y = torch.from_numpy(r.randint(0, 3, (8,)).astype("f4"))
    loop.step(x, y)
    loop.synchronize()
    tprof.set_state("run")
    for _ in range(2):
        loop.step(x, y)
    loop.synchronize()
    tprof.set_state("stop")
    tprof.dump()
    evs = json.load(open(tprof.Profiler.get().filename))["traceEvents"]
    ops = [e for e in evs if e["cat"] == "operator"]
    steps = [e for e in evs if e["cat"] == "step"]
    assert {e["name"] for e in ops} >= {"fully_connected", "log_softmax"}
    assert all(e["args"]["phase"] == "dispatch" for e in ops)
    got = sorted((e["args"]["phase"], e["args"]["step"]) for e in steps)
    assert got == sorted((ph, s) for ph in ("dispatch", "window", "retire")
                         for s in (2, 3))
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in steps)


def test_device_trace_through_torch_profiler(tmp_path):
    d = str(tmp_path / "tb")
    tprof.set_config(tensorboard_dir=d)
    tprof.set_state("run")
    x = torch.randn(16, 32)
    norm.layer_norm(x, torch.ones(32), torch.zeros(32), 1e-5)
    with tprof.scope("blk"):
        torch.mm(x, x.t())
    tprof.set_state("stop")
    assert os.path.exists(os.path.join(d, "device_trace.json"))
    keys = {e.key for e in tprof.Profiler.get().device_profile
            .key_averages()}
    assert "blk" in keys and "aten::mm" in keys
