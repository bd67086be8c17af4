"""Run telemetry: the JAX ``obs/metrics.py`` — ``RunRecorder`` with its
``pretrain``, ``round``, ``guard_event`` and ``async_event`` records,
notes, the chunk boundary (``ingest_chunk``), the wire plan,
``attach_hlo_profile`` and ``dump``. The console lines and the record
fields are the JAX package's.
"""
from __future__ import annotations

import json

import numpy as np
import torch

SCHEMA_VERSION = 1


def to_jsonable(obj):
    """Recursively convert ``obj`` into plain JSON-dumpable Python (numpy
    scalars and arrays, tensors, tuples); floats keep their bits."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "tolist"):             # torch.Tensor
        return to_jsonable(obj.tolist())
    return str(obj)


def _round_text(rec, rounds) -> str:
    """The synchronous trainer's progress line (the JAX format)."""
    vl = rec["val_loss"]
    val_s = "   skip" if vl is None else \
        f"{vl:.4f} ppl={np.exp(vl):.2f}"
    return (f"[round {rec['round']}/{rounds}] "
            f"inner={rec['inner_loss']:.4f} val={val_s} "
            f"active={rec['active']}")


def _async_text(rec) -> str:
    """The async event line (the JAX format, including the trailing space
    of an arrival without an eval). A crash record has no worker: its line
    is ``[tick T] crash`` (the JAX recorder raises a KeyError on it)."""
    if rec["event"] == "arrival":
        vs = (f"val={rec['val_loss']:.4f} ppl={rec['ppl']:.2f}"
              if "val_loss" in rec else "")
        return (f"[tick {rec['tick']}] worker {rec['worker']} "
                f"stale={rec['staleness']} w={rec['weight']:.3f} "
                f"inner={rec['inner_loss']:.4f} {vs}")
    if "worker" not in rec:
        return f"[tick {rec['tick']}] {rec['event']}"
    return (f"[tick {rec['tick']}] {rec['event']} "
            f"worker {rec['worker']}")


class RunRecorder:
    """One run's telemetry: manifest + typed records + console lines."""

    def __init__(self, *, transport: str = "simulated",
                 log_format: str = "text", manifest: dict | None = None,
                 printer=print):
        if log_format not in ("text", "json"):
            raise ValueError(f"log_format must be 'text' or 'json', "
                             f"got {log_format!r}")
        self.transport = transport
        self.log_format = log_format
        self._print = printer
        self.manifest: dict = {"schema": SCHEMA_VERSION,
                               "transport": transport}
        if manifest:
            self.manifest.update(manifest)
        self.records: list = []
        self.wire_bytes_total: float = 0.0
        self.ingest_calls: int = 0

    def _say(self, text: str, rec: dict | None = None):
        if self.log_format == "json":
            self._print(json.dumps(to_jsonable(
                rec if rec is not None else {"note": text})), flush=True)
        else:
            self._print(text, flush=True)

    def note(self, text: str, **fields):
        """A status line that is not a measurement; kept in the manifest,
        not in the record history."""
        self.manifest.setdefault("notes", []).append(
            {"note": text, **fields} if fields else {"note": text})
        self._say(text, {"note": text, **fields})

    def _emit(self, rec: dict, text: str) -> dict:
        self.records.append(rec)
        self.wire_bytes_total += float(rec.get("wire_bytes") or 0.0)
        self._say(text, rec)
        return rec

    def pretrain(self, *, step: int, loss, val_loss) -> dict:
        rec = {"kind": "round", "phase": "pretrain",
               "transport": self.transport, "inner_steps": int(step),
               "inner_loss": float(loss), "val_loss": float(val_loss)}
        return self._emit(rec, f"[pretrain {step}] "
                               f"loss={float(loss):.4f} "
                               f"val={float(val_loss):.4f}")

    def round(self, *, round: int, rounds: int, inner_steps: int,
              inner_loss, val_loss, outer_gnorm, active: int,
              dropped: int | None = None, wire_bytes=None,
              gossip_edges=None, extras: dict | None = None,
              evaled: bool = True) -> dict:
        """One outer round. ``evaled`` False marks a round the eval
        cadence skipped (val_loss recorded as None); ``gossip_edges``, the
        gossip transport's exchange pairs of the round."""
        rec = {"kind": "round", "phase": "diloco",
               "transport": self.transport, "round": int(round),
               "inner_steps": int(inner_steps),
               "inner_loss": float(inner_loss),
               "val_loss": None if not evaled else float(val_loss),
               "outer_gnorm": float(outer_gnorm), "active": int(active)}
        if dropped is not None:
            rec["dropped"] = int(dropped)
        if wire_bytes is not None:
            rec["wire_bytes"] = float(wire_bytes)
        if gossip_edges is not None:
            rec["gossip_edges"] = [list(e) for e in gossip_edges]
        if extras:
            rec.update({k: float(v) for k, v in extras.items()})
        return self._emit(rec, _round_text(rec, rounds))

    def guard_event(self, *, action: str, round: int, **fields) -> dict:
        """One anomaly-guard verdict (``resilience.guard``): a spike or
        non-finite detection, or a rollback. Host-side bookkeeping only."""
        rec = {"kind": "event", "phase": "guard",
               "transport": self.transport, "event": action,
               "round": int(round), **fields}
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        return self._emit(
            rec, f"[guard] {action} round={int(round)} {detail}".rstrip())

    def async_event(self, rec: dict) -> dict:
        """Ingest one ``AsyncEngine`` event record (keyed by ``event``,
        ``tick``, ``worker``), stamped with the kind, phase and
        transport fields."""
        rec = {"kind": "event", "phase": "diloco_async",
               "transport": self.transport, **rec}
        return self._emit(rec, _async_text(rec))

    def ingest_chunk(self, stacked_metrics: dict) -> dict:
        """One chunk's stacked metrics (``diloco.make_run``: (R,) tensors
        on the device, or host arrays) as numpy arrays — the recorder's
        only contact with device values. The device tensors are stacked
        and copied to the host in one transfer per dtype (one in practice:
        every metric is float32). ``ingest_calls`` counts the calls."""
        self.ingest_calls += 1
        out = {k: np.asarray(v) for k, v in stacked_metrics.items()
               if not torch.is_tensor(v)}
        by_dtype: dict = {}
        for k, v in stacked_metrics.items():
            if torch.is_tensor(v):
                by_dtype.setdefault(v.dtype, []).append(k)
        for keys in by_dtype.values():
            host = torch.stack([stacked_metrics[k].detach()
                                for k in keys]).cpu().numpy()
            out.update(zip(keys, host))
        return out

    def attach_wire_plan(self, plan):
        """Static outer-sync plan: what each round is scheduled to ship."""
        self.manifest["wire_plan"] = [dict(p) for p in plan]

    def attach_hlo_profile(self, profile: dict, fn: str = "round"):
        """A measured wire profile of one function (the JAX name and key,
        ``manifest["hlo_profile"][fn]``, kept so that a reader of either
        package's manifest finds it): what the program really ships, which
        the trace's byte annotations are held against. The port has no HLO;
        its profiles are counted at the collective call sites."""
        self.manifest.setdefault("hlo_profile", {})[fn] = dict(profile)

    @property
    def history(self) -> list:
        return self.records

    def round_records(self) -> list:
        return [r for r in self.records if r["kind"] == "round"
                and r["phase"] != "pretrain"]

    def event_records(self) -> list:
        return [r for r in self.records if r["kind"] == "event"]

    def payload(self, *, args: dict | None = None) -> dict:
        return to_jsonable({"args": args, "manifest": self.manifest,
                            "history": self.records})

    def dump(self, path: str, *, args: dict | None = None) -> str:
        with open(path, "w") as f:
            json.dump(self.payload(args=args), f, indent=1)
        return path
