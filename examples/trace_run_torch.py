"""Run telemetry demo on the PyTorch + CUDA port: four tiny DiLoCo runs,
four Chrome traces (the JAX ``examples/trace_run.py``).

The port's trainer (``repro_torch.launch.train``) records every run
through ``obs.metrics.RunRecorder`` and, with ``--trace``, writes the
tick-domain Chrome trace-event JSON of ``obs/trace.py``:

  trace_sync.json    barrier-paced rounds under a fault scenario:
                     heterogeneous worker speeds, link latencies and a
                     mid-run preemption, one lane per worker.
  trace_async.json   the barrier-free engine on the same scenario:
                     inner phases, per-send retries, in-flight transfer
                     spans closing at the tick the delta is applied.
  trace_gossip.json  pairwise partial averaging: exchange markers on both
                     endpoints of every realized edge, one fragment a
                     round.
  trace_overlap.json overlapped streaming on the sharded transport (two
                     pod ranks): int4 packed wire, τ=1; each fragment
                     lane shows the scheduled gather span plus the
                     "consume (measured)" marker where rank 0 waited for
                     the gather (``pod_collectives.OverlapProbe``), τ
                     inner steps after its issue.

Open them at https://ui.perfetto.dev (or chrome://tracing), or validate
them structurally:

  PYTHONPATH=src python -m repro_torch.obs.trace DIR/trace_*.json

Run on the GPU by default; ``--device cpu`` runs the plain versions:

  PYTHONPATH=src python examples/trace_run_torch.py [--outdir DIR]
"""
import argparse
import json
import os
import tempfile

from repro_torch.launch import train

FAULTS = ["--speeds", "1,2,1,3", "--link-latency", "1,1,2,1",
          "--max-retries", "1", "--preempt", "2:4:8"]
BASE = ["--arch", "diloco_60m", "--k", "4", "--H", "4", "--rounds", "3",
        "--batch", "4", "--seq", "32", "--eval-batch", "8"]

RUNS = {
    "sync": FAULTS,
    "async": ["--transport", "async", "--ticks", "12", *FAULTS],
    "gossip": ["--transport", "gossip", "--stream-fragments", "2"],
    "overlap": ["--transport", "sharded", "--stream-fragments", "2",
                "--stream-tau", "1", "--stream-alpha", "0.5",
                "--outer-grad-dtype", "int4", "--k", "2", "--pods", "2"],
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--outdir", default=None,
                    help="where the traces go (default: a new temporary "
                         "directory)")
    ap.add_argument("--full", action="store_true",
                    help="diloco_60m at full width (default: its smoke "
                         "config)")
    args = ap.parse_args()
    if args.outdir is None:
        args.outdir = tempfile.mkdtemp(prefix="diloco_traces_")
    os.makedirs(args.outdir, exist_ok=True)
    size = ["--full"] if args.full else []
    for name, extra in RUNS.items():
        path = os.path.join(args.outdir, f"trace_{name}.json")
        print(f"=== {name} -> {path} ===")
        train.run(train.make_parser().parse_args(
            ["--device", args.device, *BASE, *size, *extra,
             "--trace", path]))
        with open(path) as f:
            trace = json.load(f)
        spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        print(f"    {len(trace['traceEvents'])} events, {spans} spans\n")
    print(f"open the traces at https://ui.perfetto.dev "
          f"(files in {args.outdir})")


if __name__ == "__main__":
    main()
