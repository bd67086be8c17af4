"""The gossip transport through the port's trainer (``launch/train.py``)
against the JAX trainer, on the CPU.

- A gossip run (butterfly and random pairing, a bf16 exchange over two
  fragments, a dropped link): its round records carry the JAX trainer's
  keys for the same flags (the port adds none on this transport), the
  fragment's exchange bytes, and, under butterfly, the same edges; under
  random pairing, the edges of the partner maps the round drew.
- A crash at a round boundary and ``--resume auto`` end at the uncut
  run's ``state_sha256``: the pairings depend only on (seed, round), so
  the resumed run draws the same ones with nothing in its snapshot.
- The barrier-free refusals of the JAX trainer, with its messages.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.launch import train as jtrain  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.core import gossip as TG  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.resilience import harness  # noqa: E402

torch.set_num_threads(2)
SIZES = ["--k", "4", "--H", "2", "--rounds", "3", "--batch", "2", "--seq",
         "32", "--eval-batch", "2"]
GOSSIP = ["--transport", "gossip", "--stream-fragments", "2",
          "--outer-grad-dtype", "bfloat16", "--drop-prob", "0.3"]


def _port(flags):
    rec = tmetrics.RunRecorder(printer=lambda *a, **kw: None)
    args = train.make_parser().parse_args(["--device", "cpu", *flags])
    return train.run(args, recorder=rec), rec


@pytest.mark.parametrize("pairing", ["butterfly", "random"])
def test_gossip_records_match_the_jax_trainer(pairing):
    flags = SIZES + GOSSIP + ["--gossip-pairing", pairing, "--gossip-mix",
                              "0.3", "--rounds-per-call", "2"]
    got, rec = _port(flags)
    jrec = jmetrics.RunRecorder(printer=lambda *a, **kw: None)
    want = jtrain.run(jtrain.make_parser().parse_args(flags), recorder=jrec)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert {"gossip_edges", "gossip_spread", "gossip_frag",
            "exchange_frac"} <= set(got[0])
    for g, w in zip(got, want):
        for key in ("round", "active", "dropped", "wire_bytes",
                    "gossip_frag", "inner_steps"):
            assert g[key] == w[key], key
    assert rec.manifest["wire_plan"] == jrec.manifest["wire_plan"]
    edges = [[list(e) for e in TG.edges_of(TG.partner_map(
        4, t, pairing, seed=0))] for t in range(3)]
    assert [r["gossip_edges"] for r in got] == edges
    if pairing == "butterfly":
        assert [r["gossip_edges"] for r in got] == [r["gossip_edges"]
                                                   for r in want]
    assert all(np.isfinite(r["val_loss"]) for r in got)
    notes = [n["note"] for n in rec.manifest["notes"]]
    assert notes[0] == (f"gossip transport: {pairing} pairing, mix=0.3, "
                        f"P=2 fragment(s), {max(TG.frag_bytes(*_meta()))} "
                        "B/exchange")


def _meta():
    from repro_torch.configs.base import DiLoCoConfig
    from repro_torch.models.registry import get_smoke_arch
    params = get_smoke_arch("diloco_150m").init(generator=None,
                                                device="meta")
    return params, DiLoCoConfig(k=4, streaming_fragments=2,
                                outer_grad_dtype="bfloat16",
                                transport="gossip")


def test_gossip_crash_and_resume_match_the_uncut_run(tmp_path):
    base = ["--device", "cpu", *SIZES[:4], "--rounds", "4", *SIZES[6:],
            *GOSSIP, "--gossip-pairing", "random", "--rounds-per-call", "2"]
    uncut = str(tmp_path / "u.json")
    _port(base[2:] + ["--state-hash-out", uncut])
    ck = ["--checkpoint-dir", str(tmp_path / "c"), "--checkpoint-every",
          "2"]
    proc = harness.run_until_crash(base + ck + ["--crash-at-round", "2"],
                                   timeout=600)
    assert "crash: SIGKILL at round boundary 3" in proc.stdout
    resumed = str(tmp_path / "r.json")
    records, _ = _port(base[2:] + ck + ["--resume", "auto",
                                        "--state-hash-out", resumed])
    want, got = harness.read_json(uncut), harness.read_json(resumed)
    assert got["resumed_from_step"] == 2
    assert [r["round"] for r in records] == [3, 4]
    assert got["state_sha256"] == want["state_sha256"]


@pytest.mark.parametrize("flags,named", [
    (["--stream-alpha", "0.5"], "--stream-alpha do"),
    (["--stream-tau", "1", "--no-pack-wire"], "--stream-tau, --no-pack-wire"
     " do"),
    (["--pods", "2"], "--pods do"),
    (["--legacy-loop"], "--legacy-loop do"),
    (["--cosine-stats"], "--cosine-stats do"),
])
def test_barrier_free_refusals_match_jax(flags, named):
    """Streaming mechanics that have no meaning on gossip are refused by
    both trainers, with the JAX trainer's message."""
    argv = ["--transport", "gossip", "--k", "2", *flags]
    with pytest.raises(SystemExit, match=named):
        train.run(train.make_parser().parse_args(["--device", "cpu",
                                                  *argv]))
    with pytest.raises(SystemExit, match=named):
        jtrain.build(jtrain.make_parser().parse_args(argv))


def test_gossip_pairing_takes_jax_choices():
    for parser in (train.make_parser(), jtrain.make_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--gossip-pairing", "ring"])
    with pytest.raises(ValueError, match="int4 transport is not"):
        _port(["--transport", "gossip", "--outer-grad-dtype", "int4",
               "--k", "2", "--H", "1", "--rounds", "1"])
