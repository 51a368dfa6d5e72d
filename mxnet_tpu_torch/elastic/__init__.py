"""Elastic training (counterpart of ``mxnet_tpu/elastic``): keep a
``gluon.TrainLoop`` run alive across device loss, preemption and
transient failures.

- :mod:`.detect`: failure classification (the CUDA, NCCL and gloo texts
  of a lost card or rank), the once-per-failure ``device_lost`` record,
  preemption notices with a grace window, the ``MXNET_ELASTIC*`` gates;
- :mod:`.supervisor`: :class:`ElasticSupervisor` (in-process on one
  device, or one process group a formation across the cards),
  :class:`RecoveryLog`.

The chaos harness is ``testing/faults.py``: the ``revoke`` / ``restore``
actions and the ``step.dispatch`` / ``window.retire`` /
``prefetch.stage`` fault points.
"""
from . import detect
from .detect import (PreemptionNotice, armed, classify, clear_scoped_notices,
                     device_lost_guard, elastic_enabled, is_device_lost,
                     is_rank_lost, max_retries, maybe_record_device_lost,
                     notice, preemption_grace_sec)

__all__ = ["detect", "supervisor", "is_device_lost", "is_rank_lost",
           "classify", "maybe_record_device_lost", "device_lost_guard",
           "PreemptionNotice", "notice", "clear_scoped_notices",
           "elastic_enabled", "armed", "max_retries",
           "preemption_grace_sec", "ElasticSupervisor", "ElasticResult",
           "RecoveryLog", "StallEscalation", "recovery_log"]

_LAZY = ("ElasticSupervisor", "ElasticResult", "RecoveryLog",
         "StallEscalation", "recovery_log")


def __getattr__(name):
    # the supervisor pulls in gluon; it loads at first use so the
    # detection half stays importable from the engine's seams
    if name == "supervisor" or name in _LAZY:
        import importlib
        mod = importlib.import_module(".supervisor", __name__)
        globals()["supervisor"] = mod
        return mod if name == "supervisor" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
