"""The port's server entry point (``python -m repro_torch.launch.serve``)
on the CPU: a static batch, the continuous engine (paged and contiguous),
packed int4 weights from a ``save_packed`` file, the refusal of
``--device cuda`` without a GPU, and the other families' configs: each
serves on the static path; the engine refuses the VLM's and the
encoder-decoder's, which need a modality input. One
run goes through a subprocess (the module's entry point); the others
call ``run`` with the parsed flags."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import get_smoke_arch  # noqa: E402

torch.set_num_threads(2)
SRC = str(Path(__file__).resolve().parents[1] / "src")
BASE = ["--device", "cpu", "--batch", "3", "--prompt-len", "12", "--gen",
        "6"]


def _run(argv):
    return serve.run(serve.make_parser().parse_args(BASE + argv))


def test_serve_module_runs_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *BASE], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "-> 18 tokens in" in out.stdout and "on cpu" in out.stdout
    assert "sample tokens[0,:16]:" in out.stdout


def test_static_continuous_and_contiguous_give_one_answer(capsys):
    """At temperature 0 the static batch, the paged engine and the
    contiguous engine decode the same tokens for the same prompts."""
    static = _run([])
    paged = _run(["--continuous"])
    contiguous = _run(["--continuous", "--contiguous-cache"])
    assert static.shape == (3, 6)
    np.testing.assert_array_equal(paged, static)
    np.testing.assert_array_equal(contiguous, static)
    assert capsys.readouterr().out.count("tok/s") == 3


def test_packed_checkpoint_serves(tmp_path, capsys):
    """Weights packed from the server's own seeded params: the static
    path and the engine both serve them, with one answer."""
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    path = str(tmp_path / "w.packed.npz")
    tck.save_packed(path, arch.init(generator=gen, device="cpu"))
    static = _run(["--packed-checkpoint", path])
    engine = _run(["--packed-checkpoint", path, "--continuous"])
    np.testing.assert_array_equal(engine, static)
    assert "loaded packed weights" in capsys.readouterr().out
    with pytest.raises(ValueError, match="paged"):
        _run(["--packed-checkpoint", path, "--continuous",
              "--contiguous-cache"])


def test_cuda_without_gpu_and_other_families_are_refused(capsys):
    """The GPU half: ``--device cuda`` without a GPU is refused. The
    family half: a hybrid (zamba2) and an encoder-decoder (whisper) smoke
    config serve on the static path, zamba2 through the engine too (one
    answer); the engine refuses whisper as JAX's does."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.run(serve.make_parser().parse_args(["--gen", "2"]))
    static = _run(["--arch", "zamba2_2_7b"])
    engine = _run(["--arch", "zamba2_2_7b", "--continuous"])
    assert static.shape == (3, 6)
    assert static.min() >= 0 and static.max() < 256
    np.testing.assert_array_equal(engine, static)
    whisper = _run(["--arch", "whisper_large_v3"])
    assert whisper.shape == (3, 6) and whisper.max() < 256
    assert capsys.readouterr().out.count("arch=") == 3
    with pytest.raises(ValueError, match="learned absolute"):
        _run(["--arch", "whisper_large_v3", "--continuous"])
