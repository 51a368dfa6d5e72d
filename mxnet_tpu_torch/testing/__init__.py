"""Testing support (counterpart of ``mxnet_tpu/testing``): fault points,
so the checkpoint stack's atomicity is shown by kill -9 tests rather
than claimed in comments, and the elastic supervisor's recoveries by
devices revoked and restored mid-run."""
from . import faults
from .faults import (DeviceRevokedError, FaultInjectedError, FaultRule,
                     fault_point)

__all__ = ["faults", "fault_point", "FaultInjectedError",
           "DeviceRevokedError", "FaultRule"]
