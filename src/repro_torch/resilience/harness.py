"""Subprocess harness for crash experiments: launch real
``repro_torch.launch.train`` processes, let an injected crash SIGKILL
them, damage their newest snapshot on purpose, relaunch them with
``--resume auto`` and read back their ``--state-hash-out`` JSON (the JAX
``resilience/harness.py`` for the port).
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


def train_env() -> dict:
    """The environment for a trainer subprocess: ``src`` on
    ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_train(args, *, check: bool = True,
              timeout: float = 1200.0) -> subprocess.CompletedProcess:
    """Run one trainer subprocess to its end; ``check=False`` for a run
    that is meant to die."""
    proc = subprocess.run(train_cmd(args), env=train_env(),
                          capture_output=True, text=True, timeout=timeout)
    if check and proc.returncode != 0:
        raise RuntimeError(
            f"train subprocess failed rc={proc.returncode}\n"
            f"cmd: {' '.join(train_cmd(args))}\n"
            f"stdout:\n{proc.stdout[-4000:]}\n"
            f"stderr:\n{proc.stderr[-4000:]}")
    return proc


def run_until_crash(args, *,
                    timeout: float = 1200.0) -> subprocess.CompletedProcess:
    """Run a trainer that carries a crash injection and check that it died
    by SIGKILL (a clean exit means the injection never fired)."""
    proc = run_train(args, check=False, timeout=timeout)
    if proc.returncode != SIGKILL_RC:
        raise RuntimeError(
            f"crash-injected run exited with {proc.returncode}, not by "
            f"SIGKILL\nstdout:\n{proc.stdout[-4000:]}\n"
            f"stderr:\n{proc.stderr[-4000:]}")
    return proc


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
