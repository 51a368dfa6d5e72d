"""Joining a job of several processes (counterpart of
``mxnet_tpu/parallel/dist.py``).

The JAX package runs one program per host over a mesh of its devices.
The port takes PyTorch's idiom instead: one process per device, joined
into one ``torch.distributed`` process group. On the card the group
speaks NCCL and rank r runs on ``cuda:<local rank>``; on the CPU, and
only when the caller asks for it with ``device="cpu"``, it speaks gloo.

:func:`initialize` joins from torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or from the reference
launcher's ``DMLC_WORKER_ID`` / ``DMLC_NUM_WORKER`` / ``DMLC_PS_ROOT_URI``
/ ``DMLC_PS_ROOT_PORT``. :func:`spawn` starts a group of ranks on this
host and returns what each rank's function returned; every join it makes
has a timeout, so a rank that hangs fails the caller instead of hanging
it.

:func:`available_devices` is the surviving world, asked afresh on every
call: the visible devices less those a fault rule revoked
(``testing.faults``). On the CPU, where gloo ranks stand in for cards,
``MXNET_CPU_DEVICES`` (default 1) says how many virtual devices there
are, as the JAX package's forced host device count does.
"""
from __future__ import annotations

import datetime
import logging
import os
import pickle
import random as _pyrandom
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ["initialize", "is_initialized", "rank", "size", "local_rank",
           "device", "spawn", "shutdown", "visible_device_ids",
           "available_devices", "world_changed"]

_LOG = logging.getLogger("mxnet_tpu_torch.dist")

#: the device this process's rank runs on, once joined
_DEVICE: List[Optional[torch.device]] = [None]


def _env_int(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def _env_get(name: str, default, cast):
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return cast(v)


def _coordinator():
    """(address, port) of rank 0's store from the environment, or None."""
    if os.environ.get("MASTER_ADDR"):
        return os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT",
                                                         "29500")
    if os.environ.get("DMLC_PS_ROOT_URI"):
        return os.environ["DMLC_PS_ROOT_URI"], \
            os.environ.get("DMLC_PS_ROOT_PORT", "9000")
    return None


def _resolve(device) -> torch.device:
    """The device rule: NCCL on CUDA by default, gloo only when asked
    for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).type != "cuda":
        raise MXNetError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is available; pass device='cpu' "
                         "to join over gloo on the CPU")
    return torch.device("cuda", local_rank())


def initialize(device=None, coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join the job and return the device this rank runs on.

    Without a coordinator in the arguments or the environment there is
    nothing to join: the process is rank 0 of a world of 1. Joining races
    rank 0's startup, so it is retried with exponential backoff and
    jitter: ``MXNET_DIST_INIT_RETRIES`` attempts (default 3), each
    waiting ``timeout_s`` or ``MXNET_DIST_INIT_TIMEOUT`` seconds (default
    60). Exhausting them raises an :class:`MXNetError` naming the
    coordinator."""
    dev = _resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        _DEVICE[0] = dev
        return dev
    if coordinator_address is None:
        coord = _coordinator()
        coordinator_address = None if coord is None else "%s:%s" % coord
    num_processes = num_processes or _env_int("WORLD_SIZE",
                                              "DMLC_NUM_WORKER")
    process_id = process_id if process_id is not None \
        else _env_int("RANK", "DMLC_WORKER_ID")
    if coordinator_address is None:
        _DEVICE[0] = dev      # single process: nothing to join
        return dev
    retries = max(1, _env_get("MXNET_DIST_INIT_RETRIES", 3, int))
    if timeout_s is None:
        timeout_s = _env_get("MXNET_DIST_INIT_TIMEOUT", 60.0, float)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    last_err = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s))
            _DEVICE[0] = dev
            return dev
        except Exception as e:   # the store surfaces failures untyped
            last_err = e
            if attempt + 1 < retries:
                delay = min(30.0, 0.5 * (2 ** attempt)) \
                    * (1.0 + 0.25 * _pyrandom.random())
                _LOG.warning(
                    "dist.initialize attempt %d/%d against %s failed "
                    "(%s: %s); retrying in %.1fs", attempt + 1, retries,
                    coordinator_address, type(e).__name__, e, delay)
                time.sleep(delay)
    raise MXNetError(
        f"could not join the distributed job: coordinator "
        f"{coordinator_address} (process_id={process_id}, "
        f"num_processes={num_processes}) unreachable after {retries} "
        f"attempts; last error: {type(last_err).__name__}: {last_err}. "
        "Check DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT and that the "
        "coordinator process is up; tune MXNET_DIST_INIT_RETRIES/"
        "MXNET_DIST_INIT_TIMEOUT.") from last_err


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    v = _env_int("LOCAL_RANK")
    return v if v is not None else 0


def device() -> Optional[torch.device]:
    """The device :func:`initialize` chose for this rank (None before)."""
    return _DEVICE[0]


def _kind(kind: Optional[str]) -> str:
    if kind is not None:
        return torch.device(kind).type
    if _DEVICE[0] is not None:
        return _DEVICE[0].type
    return "cuda" if torch.cuda.is_available() else "cpu"


def visible_device_ids(kind: Optional[str] = None) -> List[int]:
    """Every device id of ``kind`` this host shows (``"cuda"``: the
    visible cards; ``"cpu"``: ``MXNET_CPU_DEVICES`` virtual ones). The
    default kind is the joined rank's, else CUDA where there is a card,
    else the CPU."""
    if _kind(kind) == "cuda":
        return list(range(torch.cuda.device_count()))
    return list(range(max(1, _env_get("MXNET_CPU_DEVICES", 1, int))))


def available_devices(kind: Optional[str] = None) -> List[torch.device]:
    """The surviving device world, asked afresh on every call (never a
    list cached at import): the visible devices less the ids a fault
    rule revoked. What the elastic supervisor sizes each formation
    from."""
    from ..testing.faults import revoked_device_ids
    k = _kind(kind)
    revoked = revoked_device_ids()
    return [torch.device(k, i) for i in visible_device_ids(k)
            if i not in revoked]


def world_changed(devices: Sequence) -> bool:
    """Whether the available world differs from ``devices`` (devices or
    ids, captured when the current world formed): True on a loss and on
    a growth."""
    devices = list(devices)
    kind = devices[0].type if devices and isinstance(
        devices[0], torch.device) else None
    ids = {d.index if isinstance(d, torch.device) else int(d)
           for d in devices}
    return {d.index for d in available_devices(kind)} != ids


def shutdown() -> None:
    """Leave the process group (a no-op when not joined)."""
    if is_initialized():
        dist.destroy_process_group()
    _DEVICE[0] = None


# ---------------------------------------------------------------------------
# spawning a group of ranks on this host
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_entry(rank_: int, fn: Callable, world: int, device_kind: str,
                 port: int, out_dir: str, args: Sequence,
                 timeout_s: float, device_ids: Sequence[int]) -> None:
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(device_ids[rank_]),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if device_kind == "cpu":
        torch.set_num_threads(1)
    initialize(device_kind, timeout_s=timeout_s)
    try:
        result = fn(*args)
    except BaseException:
        # a failed rank leaves at once, with no process-group shutdown:
        # its peers may sit inside a collective with it, and NCCL's
        # teardown (here or at the interpreter's exit) would wait for
        # them; spawn() reports this traceback and kills them
        with open(os.path.join(out_dir, f"rank{rank_}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    with open(os.path.join(out_dir, f"rank{rank_}.pkl"), "wb") as f:
        pickle.dump(result, f)
    shutdown()


def _raised_in(out_dir: str, first: int, world: int):
    """(rank, traceback) of a rank that failed with an exception (the
    one that ended the group first where it wrote one), or None."""
    for r in [first] + [r for r in range(world) if r != first]:
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                return r, f.read()
    return None


def spawn(fn: Callable, world: int, device: str = "cuda",
          args: Sequence = (), timeout_s: float = 90.0,
          device_ids: Optional[Sequence[int]] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes, rank r on
    ``cuda:r`` (NCCL; ``cuda:device_ids[r]`` when given) or, with
    ``device="cpu"``, on the CPU (gloo, one thread each), and return the
    ranks' return values in rank order.

    ``fn`` must be importable by the children (a module-level function)
    and return something picklable. The ranks join through a store on a
    free localhost port. A rank that raises fails the call with its
    traceback; a group that has not finished after ``timeout_s`` seconds
    is killed and the call raises :class:`MXNetError`."""
    import torch.multiprocessing as mp
    kind = torch.device(device).type
    device_ids = list(range(world)) if device_ids is None \
        else [int(i) for i in device_ids]
    if len(device_ids) != world:
        raise MXNetError(f"spawn: {world} ranks need {world} device ids, "
                         f"got {device_ids}")
    if kind == "cuda" and torch.cuda.device_count() <= max(device_ids):
        raise MXNetError(f"spawn: {world} ranks need {world} CUDA devices "
                         f"(NCCL refuses two ranks on one), "
                         f"{torch.cuda.device_count()} visible")
    out_dir = tempfile.mkdtemp(prefix="mxt-spawn-")
    try:
        ctx = mp.start_processes(
            _spawn_entry, args=(fn, world, kind, _free_port(), out_dir,
                                tuple(args), timeout_s, device_ids),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline
                                           - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise MXNetError(
                        f"spawn: {world} ranks did not finish within "
                        f"{timeout_s:.0f} s")
        except mp.ProcessExitedException as e:
            raised = _raised_in(out_dir, e.error_index, world)
            if raised is None:
                raise
            r, tb = raised
            raise mp.ProcessRaisedException(
                f"\n\n-- Process {r} terminated with the following "
                f"error:\n{tb}", r, ctx.processes[r].pid) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
