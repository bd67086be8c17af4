"""The port on the card: the CUDA kernels against their plain PyTorch
versions, and a DiLoCo round of the smoke config on CUDA against the same
round on the CPU.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports nothing of JAX, so it runs where JAX is not
installed; ``--noconftest`` keeps pytest from loading the JAX test setup:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco  # noqa: E402
from repro_torch.kernels import fused_adamw as TFA  # noqa: E402
from repro_torch.kernels import outer_nesterov as TON  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.registry import get_smoke_arch  # noqa: E402

ADAMW = dict(lr=3e-4, c1=0.19, c2=0.0975, b1=0.9, b2=0.95, eps=1e-8,
             weight_decay=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ulps(a, b):
    ai = a.view(torch.int32).to(torch.int64)
    bi = b.view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max()) if a.numel() else 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1000, 4099, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernels_equal_plain(cuda, n, offset):
    """Bitwise expected (same op order, IEEE div/sqrt, no contraction);
    2 ulp pass. Offset 1 misaligns every pointer: the scalar path."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    base = [torch.randn(n + offset, generator=gen, device=cuda)
            for _ in range(4)]
    p, g, m, v = (t[offset:] for t in base)
    v = v.abs()
    before = TFA.launches
    got = TFA.fused_adamw(p, g, m, v, **ADAMW)
    assert TFA.launches == before + 1
    want = tref.fused_adamw(p, g, m, v, **ADAMW)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _ulps(a, b) <= 2
    before = TON.launches
    got = TON.outer_nesterov(p, g, m, lr=0.7, momentum=0.9)
    assert TON.launches == before + 1
    want = tref.outer_nesterov(p, g, m, lr=0.7, momentum=0.9)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _ulps(a, b) <= 2


def _smoke_round(device, *, k=2, H=2, B=2, S=32, seed=0):
    """One DiLoCo round of the diloco_150m smoke config on ``device``,
    from params and tokens made on the CPU from ``seed``."""
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(seed)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (k, H * B, S),
                         generator=gen)
    params = tree.map(lambda t: t.to(device), params)
    dcfg = DiLoCoConfig(k=k, H=H)
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=4 * H)
    rnd = diloco.make_round(lambda p, b: arch.loss(p, b),
                            lambda g, b, s: toks.to(device), dcfg, tcfg,
                            batch_size=B, seq_len=S)
    state, _ = rnd(diloco.init_state(params, dcfg), None)
    return convert.state_to_numpy(state)


@pytest.mark.cuda
def test_cuda_round_matches_cpu(cuda):
    """The default kernel mode launches the kernels on the card and runs
    their plain versions on the CPU. Tolerance atol 1e-5, rtol 1e-4: the
    matmuls reduce in another order on the card."""
    n_leaves, k, H = 12, 2, 2
    a0, n0 = TFA.launches, TON.launches
    got = _smoke_round(cuda, k=k, H=H)
    assert TFA.launches - a0 == k * H * n_leaves
    assert TON.launches - n0 == n_leaves
    want = _smoke_round(torch.device("cpu"), k=k, H=H)
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
