"""Pod groups for the sharded streaming transport: the port's counterpart
of the JAX ``launch/mesh.py`` ``make_pod_mesh``.

The JAX package lays replicas over a device mesh's "pod" axis. The port
has no device mesh: its pod axis is a ``torch.distributed`` process group
of ``pods`` ranks, one process each, started by ``spawn``. Rank r
computes on ``cuda:(r % device_count)``, or on the CPU when the caller
asks for it. The backend follows from that layout and is chosen before
the run: NCCL when every rank has a card of its own; gloo when ranks
share a card (NCCL takes one rank per card) or run on the CPU. Over gloo
a CUDA buffer is staged through pinned host memory for its collective
(``core/pod_collectives.PodGroup``). The group is initialised from a file
under a fresh temporary directory, never a TCP port, so that concurrent
runs cannot collide.
"""
from __future__ import annotations

import importlib
import os
import pickle
import signal
import tempfile
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.pod_collectives import PodGroup


class Layout(NamedTuple):
    """Where the ``pods`` ranks compute and how they talk: ``devices[r]``
    is rank r's device, ``backend`` the process group's, ``staged``
    whether CUDA buffers cross through pinned host memory, ``reason``
    why."""
    pods: int
    devices: tuple
    backend: str
    staged: bool
    reason: str


def visible_devices(device_type: str) -> int:
    """Cards a run on ``device_type`` can lay ranks over (the CPU counts
    as one device)."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def default_pods(k: int, n_devices: int) -> int:
    """The JAX trainer's rule: the largest pod count p >= 2 that bands k
    evenly and tiles the devices (p divides their count, or, the port's
    ranks being processes, several ranks share each card evenly); 1 when
    none does."""
    return max((p for p in range(2, k + 1)
                if k % p == 0 and (n_devices % p == 0
                                   or p % n_devices == 0)), default=1)


def make_pod_layout(pods: int, device_type: str) -> Layout:
    """The layout of ``pods`` ranks on ``device_type`` ("cuda" or
    "cpu"), decided before any rank starts."""
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    if device_type == "cpu":
        return Layout(pods, ("cpu",) * pods, "gloo", False,
                      "ranks on the CPU")
    n = visible_devices("cuda")
    if n < 1:
        raise RuntimeError("no CUDA device is visible for the pod ranks")
    devices = tuple(f"cuda:{r % n}" for r in range(pods))
    if pods <= n:
        return Layout(pods, devices, "nccl", False,
                      "every rank has a card of its own")
    return Layout(pods, devices, "gloo", True,
                  f"{pods} ranks share {n} card(s), and NCCL takes one "
                  "rank per card")


def chips_of(layout: Layout) -> int:
    """Distinct devices the layout computes on."""
    return len(set(layout.devices))


def describe(layout: Layout) -> str:
    """The run's note on its backend: which, why, and whether buffers
    are staged."""
    stage = ("each collective's CUDA buffer staged through pinned host "
             "memory" if layout.staged else "no host staging")
    return f"backend {layout.backend} ({layout.reason}; {stage})"


def make_pod_group(layout: Layout, rank: int, init_file: str) -> PodGroup:
    """Join the process group as ``rank`` (every rank calls it) and return
    its ``PodGroup``."""
    device = torch.device(layout.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        layout.backend, init_method=f"file://{init_file}", rank=rank,
        world_size=layout.pods,
        # NCCL binds the rank to its card from the start
        **({"device_id": device} if layout.backend == "nccl" else {}))
    return PodGroup(rank, layout.pods, device=device,
                    backend=layout.backend, staged=layout.staged)


def _call(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank, target, layout, tmp, settings, args):
    threads, tf32 = settings
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    group = make_pod_group(layout, rank, os.path.join(tmp, "init"))
    try:
        result = _call(target)(group, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


class RanksKilled(RuntimeError):
    """A rank of ``spawn`` died by SIGKILL (every other rank has been
    stopped and reaped)."""


def spawn(target: str, layout: Layout, *args) -> list:
    """Run ``target(group, *args)`` on every rank of ``layout``, each in a
    process of its own (``torch.multiprocessing``, spawn), and return the
    ranks' results in rank order. ``target`` names a function of this
    package as "module:function" (a spawned child imports its module).
    Tensors in ``args`` reach the ranks through shared memory (CPU) or
    CUDA IPC (a card): one copy for all ranks. A rank that raises fails
    the call, and the other ranks are stopped. A rank that dies by
    SIGKILL (the trainer's scripted crash kills every rank at one
    boundary) raises ``RanksKilled`` once every rank has been stopped and
    reaped, so that no rank outlives the call, even one blocked in a
    collective whose peer is gone; the temporary directory is removed
    on the way out. The children take the caller's TF32 settings and an
    even share of its CPU threads."""
    settings = (max(1, torch.get_num_threads() // layout.pods),
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32))
    with tempfile.TemporaryDirectory(prefix="repro_pods_") as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(target, layout, tmp, settings, args),
                                 nprocs=layout.pods, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join():
                pass
        except Exception as err:
            codes = [p.exitcode for p in ctx.processes]
            if -signal.SIGKILL in codes:
                raise RanksKilled(f"pod ranks died by SIGKILL (exit codes "
                                  f"{codes})") from err
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(layout.pods):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
