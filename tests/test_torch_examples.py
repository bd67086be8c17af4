"""The port's examples (``examples/*_torch.py``) run end to end on the CPU
at smoke size, each in a subprocess as a user starts it
(``--device cpu``; the card is their default), and print their last
line."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "continuous_batching": ["--requests", "4"],
    "e2e_pretrain_diloco": ["--k", "2", "--H", "2", "--rounds", "2",
                            "--pretrain", "2", "--batch", "2", "--seq",
                            "32"],
    "serve_checkpoint": ["--rounds", "1", "--H", "2", "--gen", "4"],
    "streaming_diloco": ["--k", "2", "--H", "2", "--rounds", "2",
                         "--fragments", "2", "--tau", "1", "--batch", "2",
                         "--seq", "32", "--sharded"],
    "robustness_drop": ["--rounds", "2", "--H", "2", "--ticks", "4"],
    "trace_run": [],
}
LAST = {
    "continuous_batching": "rid=3",
    "e2e_pretrain_diloco": "communication per replica",
    "serve_checkpoint": "]]",
    "streaming_diloco": "counted == packed model == measured",
    "robustness_drop": "resumed bit-identically from its snapshots.",
    "trace_run": "open the traces",
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_on_cpu(name, tmp_path):
    extra = ["--outdir", str(tmp_path)] if name == "trace_run" else []
    if name == "e2e_pretrain_diloco":
        extra = ["--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
         "--device", "cpu", *SMALL[name], *extra],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert LAST[name] in lines[-1], lines[-5:]
    if name == "streaming_diloco":
        row = next(ln for ln in lines if ln.split()[:1] == ["int4"])
        model, packed, counted, measured = row.split()[1:]
        assert packed == counted == measured
    if name == "trace_run":
        assert sorted(p.name for p in tmp_path.glob("trace_*.json")) == [
            f"trace_{n}.json" for n in ("async", "gossip", "overlap",
                                        "sync")]
