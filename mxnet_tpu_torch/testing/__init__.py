"""Testing support (counterpart of ``mxnet_tpu/testing``): fault points,
so the checkpoint stack's atomicity is shown by kill -9 tests rather
than claimed in comments, and the elastic supervisor's recoveries by
devices revoked and restored mid-run. :mod:`.sched` (lazy) is the
deterministic-schedule harness: seeded, replayable thread interleavings
over the audited locks of ``analysis/threads.py``."""
from . import faults
from .faults import (DeviceRevokedError, FaultInjectedError, FaultRule,
                     fault_point)

__all__ = ["faults", "fault_point", "FaultInjectedError",
           "DeviceRevokedError", "FaultRule", "sched"]


def __getattr__(name):
    if name == "sched":
        import importlib
        return importlib.import_module(".sched", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
