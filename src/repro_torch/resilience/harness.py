"""Subprocess harness for crash experiments: launch real
``repro_torch.launch.train`` processes, let an injected crash SIGKILL
them, damage their newest snapshot on purpose, relaunch them with
``--resume auto`` and read back their ``--state-hash-out`` JSON (the JAX
``resilience/harness.py`` for the port). A trainer started with a
marker in its environment (``env=``) hands it to its pod ranks, so that
``processes_with`` can tell whether any of them outlived a crash.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# a SIGKILLed child returns -9 to subprocess
SIGKILL_RC = -9


def train_cmd(args) -> list:
    return [sys.executable, "-m", "repro_torch.launch.train",
            *[str(a) for a in args]]


def train_env(extra: dict | None = None) -> dict:
    """The environment for a trainer subprocess: ``src`` on
    ``PYTHONPATH``, plus ``extra``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def run_train(args, *, check: bool = True, timeout: float = 1200.0,
              env: dict | None = None) -> subprocess.CompletedProcess:
    """Run one trainer subprocess to its end (``env``: variables added to
    its environment); ``check=False`` for a run that is meant to die."""
    proc = subprocess.run(train_cmd(args), env=train_env(env),
                          capture_output=True, text=True, timeout=timeout)
    if check and proc.returncode != 0:
        raise RuntimeError(
            f"train subprocess failed rc={proc.returncode}\n"
            f"cmd: {' '.join(train_cmd(args))}\n"
            f"stdout:\n{proc.stdout[-4000:]}\n"
            f"stderr:\n{proc.stderr[-4000:]}")
    return proc


def run_until_crash(args, *, timeout: float = 1200.0,
                    env: dict | None = None) -> subprocess.CompletedProcess:
    """Run a trainer that carries a crash injection and check that it died
    by SIGKILL (a clean exit means the injection never fired)."""
    proc = run_train(args, check=False, timeout=timeout, env=env)
    if proc.returncode != SIGKILL_RC:
        raise RuntimeError(
            f"crash-injected run exited with {proc.returncode}, not by "
            f"SIGKILL\nstdout:\n{proc.stdout[-4000:]}\n"
            f"stderr:\n{proc.stderr[-4000:]}")
    return proc


def processes_with(key: str, value: str) -> list:
    """PIDs of the live processes whose environment holds ``key=value``
    (the marker a trainer subprocess and its pod ranks inherit), the
    multiprocessing resource tracker excepted (it exits by itself once
    its parent is gone). Reads ``/proc``; processes that vanish or cannot
    be read are skipped."""
    want = f"{key}={value}".encode()
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                env = f.read().split(b"\0")
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if want in env and b"resource_tracker" not in cmd:
            found.append(int(name))
    return found


def corrupt_latest(ckpt_dir: str, *, mode: str = "truncate") -> str:
    """Damage the newest snapshot in ``ckpt_dir`` so that it no longer
    verifies: ``truncate`` cuts the npz in half (a write killed midway),
    ``bitflip`` flips one byte in its middle (bit rot: the file opens,
    the hashes disagree). Returns its path."""
    from .manager import CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    steps = mgr.steps()
    if not steps:
        raise FileNotFoundError(f"no snapshots in {ckpt_dir}")
    path = mgr.path_of(steps[-1])
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "bitflip":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
