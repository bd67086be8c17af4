"""The port on the card: the CUDA kernels against their plain PyTorch
versions, and DiLoCo rounds of smoke configs on CUDA against the same
rounds on the CPU (diloco_150m's, under the f32 and the two bf16
policies, with and without pruning, a diloco_400m variant that takes
the flash-attention path, and streaming rounds on the int4 transport).

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports nothing of JAX, so it runs where JAX is not
installed; ``--noconftest`` keeps pytest from loading the JAX test setup:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from prune_levels import table  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco, streaming  # noqa: E402
from repro_torch.kernels import flash_attention as TFK  # noqa: E402
from repro_torch.kernels import fused_adamw as TFA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import outer_nesterov as TON  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sign_prune as TSP  # noqa: E402
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
    """Largest distance in units in the last place of the dtype (float32
    or bfloat16)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    ai = a.view(view).to(torch.int64)
    bi = b.view(view).to(torch.int64)
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
    before = TFA.launches["fused_adamw"]
    got = TFA.fused_adamw(p, g, m, v, **ADAMW)
    assert TFA.launches["fused_adamw"] == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1000, 4099, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_low_precision_adamw_equal_plain(cuda, n, offset):
    """The mixed step and the bf16 step against their plain versions: bit
    for bit expected, 2 ulp of each output's dtype pass."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    base = [torch.randn(n + offset, generator=gen, device=cuda)
            for _ in range(5)]
    # sliced after the cast, so that offset 1 misaligns bf16 too
    g, m, v, p = (t.to(torch.bfloat16)[offset:] for t in base[:4])
    v, w = v.abs(), base[4][offset:]
    before = dict(TFA.launches)
    got = TFA.fused_adamw_mixed(g, m, v, w, **ADAMW)
    want = tref.fused_adamw_mixed(g, m, v, w, **ADAMW)
    got_bf = TFA.fused_adamw(p, g, m, v, **ADAMW)
    want_bf = tref.fused_adamw(p, g, m, v, **ADAMW)
    torch.cuda.synchronize()
    assert {n: TFA.launches[n] - before[n] for n in before} == {
        "fused_adamw": 0, "fused_adamw_bf16": 1, "fused_adamw_mixed": 1}
    for a, b in zip(got + got_bf, want + want_bf):
        assert a.dtype == b.dtype and _ulps(a, b) <= 2


# (shape, frac, rows): the regimes and their boundaries (warp rows up to
# 1024 columns, rows in shared memory up to RESIDENT_MAX_COLS = 49152,
# with 24,576 to 32,772 columns around the head's 32,000, long rows past
# it; 917,507 is no multiple of 4), pointers one entry off (the scalar
# paths), and rows made to break the resolve
PRUNE_CASES = [
    *[(shape, frac, "randn") for shape, frac in (
        ((64, 896), 0.5), ((9, 32000), 0.25), ((3, 60001), 0.5),
        ((4, 200_000), 0.9), ((1, 1), 0.5), ((5, 1000), 0.9),
        ((6, 1024), 0.5), ((6, 1025), 0.5), ((3, 49152), 0.5),
        ((3, 49153), 0.5), ((2, 917_507), 0.5), ((200, 24576), 0.5),
        ((200, 24580), 0.5), ((300, 32768), 0.5), ((3, 32772), 0.5))],
    *[(shape, 0.5, "offset") for shape in (
        (5, 1000), (3, 2000), (4, 200_000), (2, 917_504))],
    *[(shape, frac, "adversarial") for shape in ((8, 896), (8, 4000),
                                                  (8, 60001))
      for frac in (0.5, 0.9999, 1e-6)],
    *[(shape, frac, "nodes") for shape in ((4, 4000), (4, 60001))
      for frac in (0.5, 0.25)]]


def _prune_input(shape, rows, gen, dev):
    """randn of ``shape``; "offset": the matrix starts one entry into its
    storage; "adversarial": rows 0-5 hold a NaN, ±inf, one value, zeros,
    many duplicates and subnormals; "nodes": each row's entries sit on the
    thresholds that its first count pass bins by."""
    R, C = shape
    off = 1 if rows == "offset" else 0
    x = torch.randn(R * C + off, generator=gen, device=dev)[off:].view(R, C)
    if rows == "nodes":
        # max 1, then the first pass's nodes and their neighbours (an ulp
        # to either side) with random signs: where the kernels' index
        # estimate must not take its floor
        x.clamp_(-0.999, 0.999)[:, 0] = 1.0
        hi0 = torch.tensor(1.0) * tref.HI_SCALE + tref.HI_FLOOR
        nodes = table(torch.tensor(0.0), hi0, 9)[1:-1]
        mag = torch.cat([nodes, torch.nextafter(nodes, hi0),
                         torch.nextafter(nodes, torch.tensor(0.0))])
        sign = torch.randint(0, 2, mag.shape, generator=torch.Generator()
                             .manual_seed(R)) * 2 - 1
        x[:, 1:1 + mag.numel()] = (mag * sign).clamp(-1, 1).to(dev)
    if rows == "adversarial":
        x[0, C // 3] = float("nan")
        x[1, C // 2], x[1, 0] = float("inf"), float("-inf")
        x[2] = 0.37
        x[3] = 0.0
        x[4] = (x[4] * 2).round() / 4
        x[5] *= 1e-40
    return x


def _same_bits(a, b):
    """Equal bit for bit, or NaN at the same places."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,frac,rows", PRUNE_CASES)
def test_cuda_sign_prune_equal_plain(cuda, shape, frac, rows):
    """Every regime: the output, each row's elected sign and its threshold
    bit for bit; the launches ``launches_for`` says the regime takes."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    x = _prune_input(shape, rows, gen, cuda)
    before = TSP.launches
    sign, hi, out = TSP.sign_prune_parts(x, frac)
    torch.cuda.synchronize()
    assert TSP.launches - before == TSP.launches_for(*shape)
    wsign, whi, wout = tref.sign_prune_parts(x, frac)
    assert torch.equal(sign, wsign) and _same_bits(hi, whi)
    assert _same_bits(out, wout) and not out.isnan().any()
    y = x.clone()
    TSP.sign_prune_(y, frac)
    assert torch.equal(y, out)


def _smoke_round(device, *, k=2, H=2, B=2, S=32, seed=0,
                 arch_name="diloco_150m", dcfg_changes=None, **cfg_changes):
    """One DiLoCo round of a smoke config (with ``cfg_changes``) on
    ``device``, from params and tokens made on the CPU from ``seed``.
    ``dcfg_changes`` (the policy, prune_frac) go to both configs' fields
    of those names."""
    arch = get_smoke_arch(arch_name)
    cfg = arch.cfg.replace(**cfg_changes)
    gen = torch.Generator().manual_seed(seed)
    params = arch.init(generator=gen, device="cpu", cfg=cfg)
    toks = torch.randint(0, arch.cfg.vocab_size, (k, H * B, S),
                         generator=gen)
    params = tree.map(lambda t: t.to(device), params)
    dc = dict(dcfg_changes or {})
    dcfg = DiLoCoConfig(k=k, H=H, **dc)
    dc.pop("prune_frac", None)
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=4 * H,
                       **dc)
    rnd = diloco.make_round(lambda p, b: arch.loss(p, b, cfg=cfg),
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
    a0, n0 = TFA.launches["fused_adamw"], TON.launches
    got = _smoke_round(cuda, k=k, H=H)
    assert TFA.launches["fused_adamw"] - a0 == k * H * n_leaves
    assert TON.launches - n0 == n_leaves
    want = _smoke_round(torch.device("cpu"), k=k, H=H)
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


# B, H, G, S, d, causal, window: the JAX ATTN_CASES kinds (GQA, sliding
# window, bidirectional, not block-aligned), each at d 64 and 128; then,
# with S = (Sq, Sk) and q, k scaled by ``amp``, the kernels' hard cases:
# large logits (scores of std 8); ragged ranges, Sq and Sk multiples of
# none of the tiles (the forward's and dq's 128 query and 32 key rows,
# dk/dv's 64 key and 32 query rows), Sq != Sk, causal (the queries start
# at Sk - Sq) and bidirectional; GQA with 4 query heads a kv head at d 128
# under a window that crosses the tile edges
FLASH_CASES = [(b, h, g, s, d, c, w) for d in (64, 128)
               for b, h, g, s, c, w in ((2, 4, 2, 128, True, 0),
                                        (1, 2, 1, 192, True, 64),
                                        (1, 4, 2, 256, False, 0),
                                        (2, 8, 2, 96, True, 0))] + [
    (2, 4, 2, 256, 128, True, 0, 8 ** 0.5),
    (1, 4, 2, (100, 357), 64, True, 0),
    (1, 4, 2, (200, 1000), 128, True, 0),
    (2, 4, 4, (150, 421), 128, True, 0),
    (1, 4, 2, (77, 201), 64, False, 0),
    (1, 8, 2, 300, 128, True, 100)]


def _flash_case(case):
    """(B, H, G, Sq, Sk, d, causal, window, amp) of a FLASH_CASES entry."""
    B, H, G, S, d, causal, window, *amp = case
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    return B, H, G, Sq, Sk, d, causal, window, amp[0] if amp else 1.0


def _flash_id(case):
    B, H, G, Sq, Sk, d, causal, window, amp = _flash_case(case)
    S = Sq if Sq == Sk else f"{Sq}x{Sk}"
    tail = "" if amp == 1.0 else f"-amp{amp:.3g}"
    return f"{B}-{H}-{G}-{S}-{d}-{causal}-{window}{tail}"


def _flash_inputs(dev, B, H, G, S, d, seed, Sk=None, amp=1.0):
    """q, k, v, dO: q and k times ``amp`` (scores of std ``amp``**2)."""
    Sk = S if Sk is None else Sk
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((B, H, S, d), (B, G, Sk, d), (B, G, Sk, d), (B, H, S, d))
    q, k, v, do = (torch.randn(s, generator=gen, device=dev) for s in shapes)
    return q * amp, k * amp, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=_flash_id)
def test_cuda_flash_kernels_match_plain(cuda, case):
    """Each of the four kernels against its plain version. Tolerances
    atol = rtol = 2e-5 forward and 5e-4 backward, the JAX package's for
    its kernels: sums run in another order (tiles, the split-TF32
    products). With large scores the forward's plain version runs in
    float64: float32's own rounding of scores of std 8 puts it ~1.5e-5
    from that (tests/test_torch_flash_tf32.py)."""
    B, H, G, S, Sk, d, causal, window, amp = _flash_case(case)
    seed = S + d + (0 if Sk == S else Sk)
    q, k, v, do = _flash_inputs(cuda, B, H, G, S, d, seed, Sk=Sk, amp=amp)
    opts = dict(causal=causal, window=window)
    before = dict(TFK.launches)
    o_plain = TFK.flash_fwd(q, k, v, **opts)
    o, lse = TFK.flash_fwd_lse(q, k, v, **opts)
    dq, dk, dv = TFK.flash_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    assert {n: TFK.launches[n] - before[n] for n in before} == {
        **dict.fromkeys(before, 0),        # the bf16 kernels' counters
        "fwd": 1, "fwd_lse": 1, "bwd_dq": 1, "bwd_dkv": 1}
    want_o, want_lse = tref.flash_fwd_lse(
        *(t.double() if amp != 1.0 else t for t in (q, k, v)), **opts)
    want_o, want_lse = want_o.float(), want_lse.float()
    want_grads = tref.flash_bwd(q, k, v, o, lse, do, **opts)
    close = lambda a, b, tol: torch.testing.assert_close(
        a, b, rtol=tol, atol=tol)
    close(o_plain, want_o, 2e-5)
    close(o, want_o, 2e-5)
    close(lse, want_lse, 2e-5)
    for got, want in zip((dq, dk, dv), want_grads):
        close(got, want, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES[:8] + FLASH_CASES[9:12],
                         ids=_flash_id)
def test_cuda_flash_bf16_kernels_match_plain(cuda, case, monkeypatch):
    """The four kernels on bf16 operands (their own launch counters)
    against their plain versions on the same bf16 tensors: both compute in
    f32 and round o, dq, dk and dv to bf16 once, so they differ by the
    f32 sums' order (split TF32 against whole rows) and the rounding flips
    that order causes: rtol 2^-7 (two bf16 ulps) with atol 2e-5 (forward)
    or 5e-4 (backward); lse (f32) at the f32 forward's 2e-5. A bf16 CUDA
    tensor never reaches a plain version (patched here to raise)."""
    B, H, G, S, Sk, d, causal, window, amp = _flash_case(case)
    seed = S + d + (0 if Sk == S else Sk) + 1
    q, k, v, do = (t.to(torch.bfloat16) for t in _flash_inputs(
        cuda, B, H, G, S, d, seed, Sk=Sk, amp=amp))
    opts = dict(causal=causal, window=window)
    plain = (tref.flash_fwd_lse, tref.flash_bwd)

    def refuse(*_a, **_k):
        raise AssertionError("a bf16 CUDA tensor reached a plain version")
    monkeypatch.setattr(tref, "flash_fwd_lse", refuse)
    monkeypatch.setattr(tref, "flash_bwd", refuse)
    before = dict(TFK.launches)
    o_plain = TFK.flash_fwd(q, k, v, **opts)
    o, lse = TFK.flash_fwd_lse(q, k, v, **opts)
    dq, dk, dv = TFK.flash_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert {n: TFK.launches[n] - before[n] for n in before} == {
        **dict.fromkeys(TFK.KERNELS, 0),
        "fwd_bf16": 1, "fwd_lse_bf16": 1, "bwd_dq_bf16": 1,
        "bwd_dkv_bf16": 1}
    for t in (o_plain, o, dq, dk, dv):
        assert t.dtype == torch.bfloat16
    want_o, want_lse = plain[0](q, k, v, **opts)
    want_grads = plain[1](q, k, v, o, lse, do, **opts)
    close = lambda a, b, tol: torch.testing.assert_close(
        a.float(), b.float(), rtol=2 ** -7, atol=tol)
    close(o_plain, want_o, 2e-5)
    close(o, want_o, 2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    for got, want in zip((dq, dk, dv), want_grads):
        close(got, want, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_bwd_deterministic(cuda, dtype):
    """The backward kernels sum in a fixed order (no atomics): two runs on
    the same inputs give bit-identical dq, dk and dv, on f32 operands and
    on bf16 ones (dk/dv's bf16 tensor-core kernel among them)."""
    q, k, v, do = (t.to(getattr(torch, dtype)) for t in
                   _flash_inputs(cuda, 2, 8, 2, 333, 128, 11))
    opts = dict(causal=True, window=0)
    o, lse = TFK.flash_fwd_lse(q, k, v, **opts)
    first = TFK.flash_bwd(q, k, v, o, lse, do, **opts)
    second = TFK.flash_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_model_layout_and_checks(cuda):
    """The model's (B, S, H, d) tensors go in as transposed views (no
    copy); autograd through the kernels matches autograd through the
    plain full-softmax attention; an unbuilt head dim raises."""
    q, k, v, do = _flash_inputs(cuda, 2, 4, 2, 256, 128, 7)
    q, k, v, do = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    grads = []
    for mode in ("kernel", "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tops.flash_attention(*leaves, causal=True, mode=mode)
        grads.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    with pytest.raises(ValueError, match="head dims"):
        TFK.flash_fwd(*(torch.zeros(1, 2, 128, 32, device=cuda)
                        for _ in range(3)))


@pytest.mark.cuda
def test_cuda_flash_round_matches_cpu(cuda):
    """A k=2, H=2 round of the diloco_400m smoke config with head_dim 128
    and use_pallas (seq 128: the flash branch) on the card against the CPU.
    With remat each inner step runs the forward twice: 2·L fwd_lse, L
    bwd_dq and L bwd_dkv launches per replica step."""
    k, H, L = 2, 2, 2
    changes = dict(arch_name="diloco_400m", S=128, use_pallas=True,
                   head_dim=128)
    before = dict(TFK.launches)
    got = _smoke_round(cuda, k=k, H=H, **changes)
    steps = k * H
    assert {n: TFK.launches[n] - before[n] for n in before} == {
        **dict.fromkeys(before, 0),        # the bf16 kernels' counters
        "fwd": 0, "fwd_lse": 2 * L * steps, "bwd_dq": L * steps,
        "bwd_dkv": L * steps}
    want = _smoke_round(torch.device("cpu"), k=k, H=H, **changes)
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("pdt,mdt,frac", [
    ("bfloat16", "float32", 0.5), ("bfloat16", "bfloat16", 0.0)])
def test_cuda_low_precision_round_matches_cpu(cuda, pdt, mdt, frac):
    """A k=2, H=2 round under a bf16 policy (the mixed one with pruning) on
    the card against the CPU, with the tolerances of
    tests/test_torch_mixed.py (``check.mismatch_shares``); with pruning
    at most 0.1% of a leaf's entries outside them (entries at a row's
    threshold)."""
    k, H, n_leaves = 2, 2, 12
    changes = dict(param_dtype=pdt, master_dtype=mdt, prune_frac=frac)
    before, p0 = dict(TFA.launches), TSP.launches
    got = _smoke_round(cuda, k=k, H=H, dcfg_changes=changes)
    steps = k * H * n_leaves
    mixed = mdt == "float32"
    assert {n: TFA.launches[n] - before[n] for n in before} == {
        "fused_adamw": 0, "fused_adamw_bf16": 0 if mixed else steps,
        "fused_adamw_mixed": steps if mixed else 0}
    assert (TSP.launches > p0) == (frac > 0)
    want = _smoke_round(torch.device("cpu"), k=k, H=H, dcfg_changes=changes)
    for path, share in check.mismatch_shares(got, want, H=H,
                                             pure=not mixed).items():
        assert share <= (1e-3 if frac else 0.0), path


def _bits_equal(a, b):
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)) and bool(torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int4", "bfloat16"])
@pytest.mark.parametrize("rows,n,offset", [
    (1, 128, 0), (1, 1000, 1), (2, 300, 0), (3, 4099, 1), (2, 1 << 20, 0),
    (1, 1, 0)])
def test_cuda_fake_quant_equal_plain(cuda, dtype, rows, n, offset):
    """The kernel bit for bit against its plain version (NaN at the same
    places), blocks restarting at each row, in place and out of place; a
    NaN or an infinity makes its whole int4 block NaN."""
    gen = torch.Generator(device=cuda).manual_seed(rows * n + offset)
    x = torch.randn(rows * n + offset, generator=gen,
                    device=cuda)[offset:].view(rows, n)
    if n >= 300:
        x[0, 5] = float("nan")
        x[-1, 130] = float("inf")
        x[0, 256:270] = -0.0
    before = dict(TQ.launches)
    got = TQ.fake_quant(x, dtype, rows=rows)
    y = x.clone()
    TQ.fake_quant(y, dtype, rows=rows, out=y)
    torch.cuda.synchronize()
    want = tref.fake_quant_rows(x, dtype)
    assert _bits_equal(got, want) and _bits_equal(y, want)
    assert TQ.launches[dtype] - before[dtype] == 2
    if dtype == "int4" and n >= 300:
        assert torch.isnan(got[0, :128]).all()
        assert torch.isnan(got[-1, 128:256]).all()


@pytest.mark.cuda
def test_cuda_stream_round_matches_cpu(cuda):
    """Two k=2 streaming rounds of the smoke config (P=2, τ=1, α=0.5, int4
    with error feedback) on the card against the CPU, within
    ``check.stream_mismatch_shares`` and the int4 flip share, each entry
    outside within the code steps recorded on the CPU; the card launched
    fake_quant once per leaf and send."""
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (2, 2, 2 * 2, 32),
                         generator=gen)
    dcfg = DiLoCoConfig(k=2, H=2, streaming_fragments=2, stream_tau=1,
                        stream_alpha=0.5, outer_grad_dtype="int4",
                        error_feedback=True)

    def run(device):
        rnd = diloco.make_round(
            lambda p, b: arch.loss(p, b), lambda r, b, s: toks[r].to(device),
            dcfg, TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=8),
            batch_size=2, seq_len=32)
        st = streaming.init_state(tree.map(lambda t: t.to(device), params),
                                  dcfg)
        for r in range(2):
            st, _ = rnd(st, r)
        return convert.stream_state_to_numpy(st)

    from repro_torch.core import fragments
    meta = arch.init(generator=None, device="meta")
    sends = sum(len(r) for r in fragments.fragment_regions(
        fragments.partition_params(meta, 2), meta))
    q0 = TQ.launches["int4"]
    got = run(cuda)
    assert TQ.launches["int4"] - q0 == 2 * sends
    with check.TransportSteps(params, dcfg) as steps:
        want = run(torch.device("cpu"))
    for path, share in check.stream_mismatch_shares(got, want, H=2,
                                                    steps=steps).items():
        assert share <= check.TRANSPORT_FLIP_SHARE["int4"], path


def _wire_input(n, kind, offset, dev):
    gen = torch.Generator(device=dev).manual_seed(n + offset)
    x = torch.randn(n + offset, generator=gen, device=dev)[offset:] * 1e-2
    if kind == "special" and n > 300:
        x[5] = float("nan")
        x[130] = float("inf")
        x[200] = -float("inf")
        x[256:384] = 0.0
        x[384::7] = -0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 127, 128, 129, 300, 1000, 4099,
                               (1 << 20) + 3])
@pytest.mark.parametrize("kind", ["normal", "special"])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_wire_codecs_equal_plain(cuda, n, kind, offset):
    """``quantize_pack_int4`` and ``unpack_dequantize_int4`` against their
    plain versions on the same card tensors: the wire byte for byte (the
    NaN block's scale bytes too), the local values and the decode bit for
    bit (NaN at the same places). Offset 1 misaligns the input: the
    scalar path."""
    x = _wire_input(n, kind, offset, cuda)
    want_wire, want_local = tref.wire_encode_int4(x)
    before = dict(TQ.launches)
    wire = torch.empty(tops.wire_elems(n, "int4"), dtype=torch.uint8,
                       device=cuda)
    local = torch.empty(n, device=cuda)
    TQ.quantize_pack_int4(x, wire, local)
    got = TQ.unpack_dequantize_int4(wire, n)
    torch.cuda.synchronize()
    assert torch.equal(wire, want_wire)
    assert _bits_equal(local, want_local)
    assert _bits_equal(got, tref.wire_decode_int4(want_wire, n))
    wire2 = torch.full_like(wire, 0xAB)
    TQ.quantize_pack_int4(x, wire2)          # no local: the same wire
    torch.cuda.synchronize()
    assert torch.equal(wire2, want_wire)
    assert TQ.launches["quantize_pack_int4"] - before[
        "quantize_pack_int4"] == 2
    assert TQ.launches["unpack_dequantize_int4"] - before[
        "unpack_dequantize_int4"] == 1


@pytest.mark.cuda
def test_cuda_async_run_matches_cpu(cuda):
    """Scenario B of the async parity tests (speeds (1, 2), drops at 0.3
    with one retry, worker 1 preempted from tick 3 to 5; 8 ticks) on a
    config whose leaves straddle int4 blocks, int4 with error feedback,
    on the card against the CPU: every ``state_to_tree`` leaf within
    ``check.async_mismatch_shares`` and the int4 flip share, each entry
    outside within the code steps recorded on the CPU; one launch of each
    wire kernel per arrival."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import async_diloco, faults
    from repro_torch.models.registry import Arch

    arch = Arch(cfg=ModelConfig(name="tiny", family="dense", n_layers=2,
                                d_model=40, n_heads=2, n_kv_heads=2,
                                d_ff=72, vocab_size=64, remat=False,
                                attn_chunk=32))
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, 64, (64, 2, 16), generator=gen)
    dcfg = DiLoCoConfig(k=2, H=3, transport="async", staleness_lambda=0.7,
                        outer_grad_dtype="int4", error_feedback=True)
    scen = faults.Scenario(speeds=(1, 2), drop_prob=0.3, max_retries=1,
                           preemptions=((1, 3, 5),), seed=0)

    def run(device):
        it = iter(toks.to(device))
        eng = async_diloco.AsyncEngine(
            lambda p, b: arch.loss(p, b), lambda g, b, s: next(it), dcfg,
            TrainConfig(inner_lr=3e-3, warmup_steps=2, total_steps=64,
                        batch_size=2, seq_len=16), scenario=scen)
        st = eng.init_state(tree.map(lambda t: t.to(device), params))
        st, hist = eng.run(st, ticks=8)
        return convert.async_state_to_numpy(st), hist

    q0 = dict(TQ.launches)
    got, hist = run(cuda)
    arrivals = sum(r["event"] == "arrival" for r in hist)
    for name in ("quantize_pack_int4", "unpack_dequantize_int4"):
        assert TQ.launches[name] - q0[name] == arrivals
    with check.TransportSteps(params, dcfg) as steps:
        want, whist = run(torch.device("cpu"))
    assert [r["event"] for r in hist] == [r["event"] for r in whist]
    for path, share in check.async_mismatch_shares(got, want, H=3,
                                                   steps=steps).items():
        assert share <= check.TRANSPORT_FLIP_SHARE["int4"], path


def _gathered_wires(k, n, kind, device):
    """(k, W) uint8 int4 wires of k random payloads (the kind's special
    entries in replica 1; "special": NaN, ±inf, zero and −0.0 blocks and
    a NaN scale on the masked-out last replica) and a (k,) mask with a
    zero, on ``device``."""
    gen = torch.Generator().manual_seed(n * 10 + k)
    xs = torch.randn(k, n, generator=gen) * 1e-2
    if kind == "special":
        xs[1, 5 % n] = float("nan")
        xs[1, min(130, n - 1)] = float("inf")
        xs[0, n // 3] = -float("inf")
        xs[0, :min(n, 128)] = -0.0
        xs[1, n // 2:] = 0.0
    wires = torch.stack([tref.wire_encode_int4(x)[0] for x in xs])
    if kind == "special":
        cb, pad, _ = tref.wire_sections(n)
        wires[k - 1, cb + pad:cb + pad + 4] = torch.tensor(
            [float("nan")]).view(torch.uint8)
    m = torch.rand(k, generator=gen) + 0.1
    m[k - 1] = 0.0
    return wires.to(device), m.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 4099, (1 << 20) + 3])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", ["normal", "special"])
def test_cuda_unpack_dequantize_reduce_equal_plain(cuda, n, k, kind):
    """``unpack_dequantize_reduce`` against its plain version on the same
    card tensors, bit for bit (NaN at the same places), read in place
    from a column slice of a wider gathered buffer; one launch each."""
    wires, m = _gathered_wires(k, n, kind, cuda)
    wide = torch.zeros((k, wires.shape[1] + 12), dtype=torch.uint8,
                       device=cuda)
    wide[:, 4:4 + wires.shape[1]] = wires
    before = TQ.launches["unpack_dequantize_reduce"]
    for g in (wires, wide[:, 4:4 + wires.shape[1]]):
        got = TQ.unpack_dequantize_reduce(g, n, m)
        torch.cuda.synchronize()
        want = tref.wire_reduce_int4(wires, n, m)
        assert _bits_equal(got, want)
    assert TQ.launches["unpack_dequantize_reduce"] - before == 2
    denom = torch.clamp(m.sum(), min=1e-9)
    a = tops.wire_reduce(wires, n, "int4", m, denom, mode="kernel")
    b = tops.wire_reduce(wires, n, "int4", m, denom, mode="ref")
    torch.cuda.synchronize()
    assert _bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 1000, 4097])
@pytest.mark.parametrize("kind", ["normal", "special"])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_unfused_codecs_equal_plain(cuda, rows, kind, offset):
    """``quantize_int4``, ``dequantize_int4``, ``pack_int4`` and
    ``unpack_int4`` against their plain versions on the same card
    tensors, bit for bit; offset 1 misaligns the operands (the scalar
    paths); one launch each."""
    gen = torch.Generator().manual_seed(rows)
    flat = torch.randn(rows * 128 + offset, generator=gen) * 1e-2
    x = flat[offset:].view(rows, 128)
    if kind == "special":
        x[0, 5] = float("nan")
        x[-1, 7] = float("inf")
        x[rows // 2, 9] = -float("inf")
        if rows > 2:
            x[1] = -0.0
            x[2] = 0.0
    xd = torch.empty(rows * 128 + offset, device=cuda)[offset:].view(
        rows, 128)
    xd.copy_(x)
    before = dict(TQ.launches)
    codes, scales = TQ.quantize_int4(xd)
    wc, ws = tref.quantize_int4(xd)
    deq = TQ.dequantize_int4(codes, scales)
    cbuf = torch.empty(rows * 128 + offset, dtype=torch.int8,
                       device=cuda)[offset:].view(rows, 128)
    cbuf.copy_(wc)
    packed = TQ.pack_int4(cbuf)
    pbuf = torch.empty(rows * 64 + offset, dtype=torch.int8,
                       device=cuda)[offset:].view(rows, 64)
    pbuf.copy_(packed)
    back = TQ.unpack_int4(pbuf)
    torch.cuda.synchronize()
    assert torch.equal(codes, wc)
    assert torch.equal(scales.view(torch.int32), ws.view(torch.int32))
    assert _bits_equal(deq, tref.dequantize_int4(wc, ws))
    assert torch.equal(packed, tref.pack_int4(wc.reshape(-1)).view(rows, 64))
    assert torch.equal(back, wc)
    assert {n: TQ.launches[n] - before[n] for n in before} == {
        **dict.fromkeys(before, 0), "quantize_int4": 1,
        "dequantize_int4": 1, "pack_int4": 1, "unpack_int4": 1}


# ---- the serving path: cache ops and the engine, card against the CPU ----

@pytest.mark.cuda
@pytest.mark.parametrize("S,pos", [(1, 9), (5, 10), (14, 3)])
def test_cuda_paged_kv_update_equals_cpu(cuda, S, pos):
    """The paged write and the dense gather move values: the card's pool
    and view equal the CPU's bit for bit (unmapped pages, a wrapping ring,
    more new tokens than the ring)."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(S)
    n_pages, ps, G, hd, B = 7, 4, 2, 8, 3
    cache = {"kp": torch.randn(n_pages, ps, G, hd, generator=g),
             "vp": torch.randn(n_pages, ps, G, hd, generator=g),
             "posp": torch.randint(-1, 30, (n_pages, ps), generator=g,
                                   dtype=torch.int32)}
    table = np.array([[2, 0, -1], [5, -1, 6], [-1, -1, -1]], np.int32)
    k = torch.randn(B, S, G, hd, generator=g)
    v = torch.randn(B, S, G, hd, generator=g)
    on = {n: t.to(cuda) for n, t in cache.items()}
    want = L.paged_kv_update(cache, table, k, v, pos)
    got = L.paged_kv_update(on, table, k.to(cuda), v.to(cuda), pos)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)
    for n in cache:
        assert torch.equal(on[n].cpu(), cache[n])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 32])
def test_cuda_serving_matches_cpu(cuda, window, tmp_path):
    """diloco_150m's smoke config served on the card and on the CPU: the
    prefill logits within ``check.SERVE_LOGIT_RTOL`` of the CPU's largest
    logit; the paged engine with packed int4 weights and the contiguous
    one give one answer on the card; each request's tokens are the CPU's
    wherever the CPU's top-2 margin is wider than the tolerance; every
    forward decodes the packed regions (``unpack_dequantize_int4``)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.models.registry import Arch
    arch = get_smoke_arch("diloco_150m")
    arch = Arch(cfg=arch.cfg.replace(window=window))
    params = arch.init(generator=torch.Generator().manual_seed(0),
                       device="cpu")
    path = str(tmp_path / "w.npz")
    man = ckpt.save_packed(path, params)
    packed = ckpt.load_packed(path)
    deq = ckpt.restore_packed(path, params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n) for n in (12, 7, 19, 5)]
    gens = [6, 1, 9, 8]
    runs = {}
    for dev, paged in (("cpu", True), (cuda, True), (cuda, False)):
        eng = ContinuousBatcher(
            arch, tree.map(lambda t: t.to(dev), deq), slots=2,
            cache_len=96, paged=paged, device=dev,
            packed_weights=packed if paged else None,
            record_logits=range(4))
        TQ.launches["unpack_dequantize_int4"] = 0
        rids = [eng.submit(p, n) for p, n in zip(prompts, gens)]
        out = eng.run_until_drained()
        runs[(str(dev), paged)] = ([out[r] for r in rids], eng.logits)
        if str(dev) != "cpu" and paged:
            assert TQ.launches["unpack_dequantize_int4"] == \
                len(packed["buffers"]) * (eng.decode_steps + eng.prefills)
    card, contiguous = runs[("cuda", True)], runs[("cuda", False)]
    for a, b in zip(card[0], contiguous[0]):
        np.testing.assert_array_equal(a, b)
    cpu = runs[("cpu", True)]
    for rid, (toks, ref) in enumerate(zip(card[0], cpu[0])):
        got = torch.stack(card[1][rid])
        want = torch.stack(cpu[1][rid])
        n = min(len(got), len(want))
        res = check.serve_mismatches(toks[:n], got[:n], want[:n])
        assert res["bad"] == [] and res["max_logit_err"] <= \
            check.SERVE_LOGIT_RTOL, res
    assert man["dtype"] == "int4"


@pytest.mark.cuda
@pytest.mark.parametrize("pods", [2, 4])
def test_cuda_pod_exchange_nccl_equals_mix_round(cuda, pods):
    """``PodGroup.exchange`` with a card per rank (NCCL): the two ranks of
    a pair post their send and their receive as one batch, so bands of
    64 MB (2 pods) and 32 MB (4 pods) pass without a deadlock, and every
    band of the result equals ``mix_round``'s on the CPU bit for bit (the
    mix is the same elementwise ops in the same order)."""
    if torch.cuda.device_count() < pods:
        pytest.skip(f"needs {pods} cards: NCCL takes one rank per card")
    from repro_torch.core import gossip
    from repro_torch.launch import mesh

    k = 4
    rng = np.random.default_rng(pods)
    est = {"w": rng.standard_normal((k, 1 << 23)).astype(np.float32)}
    stages = [0, 1]
    want = {s: convert.params_to_numpy(gossip.mix_round(
        convert.params_from_numpy(est, device="cpu"),
        gossip.partner_map(k, s, "butterfly"),
        tree.map(lambda _: 1.0, est), mix=0.5))["w"] for s in stages}
    layout = mesh.make_pod_layout(pods, "cuda")
    assert layout.backend == "nccl" and not layout.staged
    ranks = mesh.spawn("repro_torch.launch.pod_rounds:gossip_exchanges",
                       layout, convert.params_from_numpy(est, device="cpu"),
                       stages, 0.5)
    k_loc = k // pods
    for r, by_stage in enumerate(ranks):
        for s, (band, exchanges) in zip(stages, by_stage):
            np.testing.assert_array_equal(
                band["w"], want[s][r * k_loc:(r + 1) * k_loc])
            assert exchanges == (1 if (1 << s) >= k_loc else 0)
