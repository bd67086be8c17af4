"""The port's trainer entry point, run on the CPU.

``--device cpu`` is the caller's explicit choice (the default is
``cuda``). The console and ``--out`` formats are held against the JAX
package's ``RunRecorder`` fed the same numbers.
"""
from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402

torch.set_num_threads(2)
SRC = str(Path(__file__).resolve().parents[1] / "src")
ROUND_LINE = re.compile(r"^\[round (\d+)/2\] inner=\d+\.\d{4} "
                        r"val=\d+\.\d{4} ppl=\d+\.\d{2} active=2$")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_train_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "run.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--k", "2", "--H", "2", "--rounds", "2", "--batch", "2", "--seq",
         "32", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    rounds = [ln for ln in lines if ln.startswith("[round")]
    assert [ROUND_LINE.match(ln).group(1) for ln in rounds] == ["1", "2"]
    assert re.match(r"^done in \d+\.\ds; entropy floor = \d+\.\d{4} "
                    r"\(ppl \d+\.\d{2}\)$", lines[-2])
    assert lines[-1] == f"wrote {out}"
    hist = json.loads(out.read_text())["history"]
    assert [r["round"] for r in hist] == [1, 2]
    for r in hist:
        assert math.isfinite(r["inner_loss"]) and math.isfinite(r["val_loss"])
        assert r["wire_bytes"] > 0


def test_recorder_format_matches_jax():
    """The same numbers through both recorders give the same console
    lines and the same records."""
    said = {"jax": [], "torch": []}
    recs = {"jax": jmetrics.RunRecorder(printer=lambda s, **_:
                                        said["jax"].append(s)),
            "torch": tmetrics.RunRecorder(printer=lambda s, **_:
                                          said["torch"].append(s))}
    for rec in recs.values():
        rec.pretrain(step=10, loss=5.25, val_loss=5.5)
        rec.round(round=1, rounds=3, inner_steps=14, inner_loss=4.125,
                  val_loss=4.25, outer_gnorm=0.5, active=2, dropped=0,
                  wire_bytes=1024.0, extras={"drop_frac": 0.0})
        rec.round(round=2, rounds=3, inner_steps=18, inner_loss=4.0,
                  val_loss=float("nan"), outer_gnorm=0.25, active=1,
                  evaled=False)
    assert said["torch"] == said["jax"]
    assert recs["torch"].records == recs["jax"].records


SHARDED = ["--transport", "sharded", "--pods", "2", "--stream-fragments",
           "2"]


# ``--trace`` was refused by name (ROADMAP.md, telemetry) until the
# telemetry slice ported it: it now writes a trace that both packages'
# validators accept, its wire bytes those of the recorder
@pytest.mark.parametrize("flags", [["--trace", "t.json"]])
def test_unported_flags_exit_with_roadmap_item(flags, tmp_path):
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace
    flags = [str(tmp_path / f) if f.endswith(".json") else f for f in flags]
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--k", "2", "--H", "2", "--rounds", "1",
         "--batch", "2", "--seq", "16", "--eval-batch", "2", *flags])
    rec = tmetrics.RunRecorder(printer=lambda *a, **k: None)
    train.run(args, recorder=rec)
    trace = json.loads((tmp_path / "t.json").read_text())
    assert ttrace.validate_trace(trace) == []
    assert jtrace.validate_trace(trace) == []
    # one delivered send span per replica (k=2) of the per-replica bytes
    # each round record carries
    assert ttrace.trace_wire_bytes(trace) == 2 * rec.wire_bytes_total > 0


# the flags the test above refused until the gossip transport and the
# sharded transport's snapshots were ported: each now runs
@pytest.mark.parametrize("flags", [
    ["--transport", "gossip"], ["--gossip-pairing", "random"],
    ["--gossip-mix", "0.3", "--stream-fragments", "2"],
    SHARDED + ["--checkpoint-dir", "ckpt"],
    SHARDED + ["--checkpoint-dir", "ckpt", "--resume", "auto"],
    ["--transport", "gossip", "--checkpoint-dir", "ckpt"]])
def test_formerly_unported_flags_run(flags, tmp_path):
    flags = [str(tmp_path / f) if f == "ckpt" else f for f in flags]
    rec = tmetrics.RunRecorder(printer=lambda s, **_: None)
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--k", "2", "--H", "2", "--rounds", "1",
         "--batch", "2", "--seq", "16", "--eval-batch", "2", *flags])
    records = train.run(args, recorder=rec)
    rounds = [r for r in records if r["phase"] == "diloco"]
    assert len(rounds) == 1 and math.isfinite(rounds[0]["val_loss"])
    assert ("gossip_edges" in rounds[0]) == (args.transport == "gossip")
    notes = [n["note"] for n in rec.manifest["notes"]]
    assert ("resume: no verified snapshot, starting fresh" in notes) == \
        ("--resume" in flags)


@pytest.mark.parametrize("flags,named", [
    pytest.param(["--transport", "sharded"], "--transport require",
                 id="flags0-transports"),
    pytest.param(["--pods", "2", "--stream-fragments", "2"],
                 "--pods requires --transport sharded",
                 id="flags1-transports"),
    (["--outer-grad-dtype", "int4"], "--outer-grad-dtype require"),
    (["--stream-alpha", "0.5", "--stream-tau", "1", "--error-feedback"],
     "--stream-alpha, --stream-tau, --error-feedback require"),
])
def test_streaming_knobs_need_stream_fragments(flags, named):
    """Without ``--stream-fragments`` the streaming knobs (the sharded
    transport among them) exit with the JAX driver's message, and
    ``--pods`` without the sharded transport with its own."""
    args = train.make_parser().parse_args(["--device", "cpu", *flags])
    with pytest.raises(SystemExit, match=named):
        train.run(args)


@pytest.mark.parametrize("extra", [
    [], ["--param-dtype", "bfloat16", "--master-dtype", "float32",
         "--prune-frac", "0.5"]])
def test_streaming_cli_runs_on_cpu(extra):
    """``--stream-fragments 2 --stream-tau 1 --stream-alpha 0.5
    --outer-grad-dtype int4 --error-feedback`` (and under the mixed policy
    with pruning) trains; the records carry the stream byte counts and the
    recorded wire plan is the streaming sync plan's."""
    rec = tmetrics.RunRecorder(printer=lambda s, **_: None)
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--k", "2", "--H", "2", "--rounds", "2",
         "--batch", "2", "--seq", "32", "--eval-batch", "2",
         "--stream-fragments", "2", "--stream-tau", "1", "--stream-alpha",
         "0.5", "--outer-grad-dtype", "int4", "--error-feedback", *extra])
    records = train.run(args, recorder=rec)
    rounds = [r for r in records if r["phase"] == "diloco"]
    assert len(rounds) == 2
    for r in rounds:
        assert math.isfinite(r["inner_loss"]) and math.isfinite(r["val_loss"])
        assert 0 < r["stream_peak_sync_bytes"] < r["stream_round_sync_bytes"]
        assert r["wire_bytes"] == r["stream_round_sync_bytes"]
    assert rounds[1]["outer_gnorm"] > 0
    plan = rec.manifest["wire_plan"]
    assert [p["fragment"] for p in plan] == [0, 1]
    assert [(p["send_step"], p["apply_step"]) for p in plan] == [(2, 3),
                                                                 (1, 2)]
    assert sum(p["wire_bytes"] for p in plan) == rounds[0]["wire_bytes"]


@pytest.mark.parametrize("mode", ["pallas", "interpret"])
def test_tpu_kernel_modes_rejected(mode):
    args = train.make_parser().parse_args(["--device", "cpu",
                                           "--kernel-mode", mode])
    with pytest.raises(SystemExit, match="auto\\|kernel\\|ref"):
        train.run(args)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda is valid here")
    args = train.make_parser().parse_args(["--k", "2", "--H", "1",
                                           "--rounds", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(args)


def test_port_imports_no_jax():
    """Every module of the port imports, and neither ``jax`` nor the JAX
    package ``repro`` is loaded by it."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 25, names\n"
        "new = {'repro_torch.checkpoint.checkpoint',\n"
        "       'repro_torch.core.gossip',\n"
        "       'repro_torch.launch.batching',\n"
        "       'repro_torch.launch.comm_analysis',\n"
        "       'repro_torch.launch.dryrun',\n"
        "       'repro_torch.launch.op_cost',\n"
        "       'repro_torch.launch.serve',\n"
        "       'repro_torch.sharding.spec',\n"
        "       'repro_torch.models.mla', 'repro_torch.models.moe',\n"
        "       'repro_torch.models.ssm', 'repro_torch.models.xlstm',\n"
        "       'repro_torch.configs.olmoe_1b_7b',\n"
        "       'repro_torch.configs.whisper_large_v3',\n"
        "       'repro_torch.obs.trace',\n"
        "       'repro_torch.resilience.guard',\n"
        "       'repro_torch.resilience.harness',\n"
        "       'repro_torch.resilience.manager',\n"
        "       'repro_torch.resilience.state_codec'}\n"
        "assert new <= set(names), new - set(names)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the card's script and the torch examples import neither either
    root = Path(SRC).parent
    examples = sorted(str(p.relative_to(root))
                      for p in (root / "examples").glob("*_torch.py"))
    assert len(examples) == 7, examples
    for script in ("chip_smoke.py", *examples):
        mods = set()
        for node in ast.walk(ast.parse((root / script).read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module.split(".")[0])
        assert not mods & {"jax", "jaxlib", "repro"}, (script, mods)


def test_pretrain_phase_then_diloco():
    """``--pretrain-steps`` runs single-worker AdamW steps first and logs
    them as pretrain records."""
    said = []
    rec = tmetrics.RunRecorder(printer=lambda s, **_: said.append(s))
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--k", "2", "--H", "1", "--rounds", "1",
         "--batch", "2", "--seq", "16", "--pretrain-steps", "2",
         "--log-every", "1", "--eval-batch", "2"])
    records = train.run(args, recorder=rec)
    assert [r["phase"] for r in records] == ["pretrain", "pretrain",
                                             "diloco"]
    assert said[0].startswith("[pretrain 1] loss=")
    assert records[-1]["inner_steps"] == 3
