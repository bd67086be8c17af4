"""The sharded transport's deferred consumer and the unfused int4 codec
pieces, against the JAX package's, on the same numpy inputs:
``unpack_dequantize_reduce`` (``ops.wire_reduce``), ``quantize_int4``,
``dequantize_int4``, ``pack_int4`` and ``unpack_int4``.

The unfused pieces are exact maps, held to JAX ``kernels/ref.py`` bit for
bit (NaN payloads aside). The reduce sums k replicas' decoded values
weighted by the mask: the port sums in replica order (``ref.
weighted_sum``, the order its kernel follows, bit for bit), JAX in the
order its tensordot (``ref`` mode) or its Pallas reduction (``interpret``
mode) takes. Each of the k products and sums rounds once, so the two
agree within 2^-21 · Σ_j |m_j·v_j| / denom per entry (four roundings of
the entry's magnitude scale); the grid below and a wider random sweep
(k ∈ {2, 4}, n up to 100,000, masks with zeros and scales of 1e-4 to 1)
read at most 2.38e-7 · Σ_j |m_j·v_j| / denom, two roundings. Special
values agree exactly in kind: a block holding a NaN or an infinity
decodes to NaN, and a zero mask entry still multiplies, so a NaN scale on
a masked-out replica poisons its block in both, as JAX's m · vals does.

The port runs its plain versions here (CPU tensors); the CUDA kernels are
held to them bit for bit in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 20.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quantize as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)
SIZES = [1, 127, 128, 129, 1000, 4099]
KINDS = ["normal", "nan", "inf", "negzero", "nan_scale_masked"]
REDUCE_RTOL = 2.0 ** -21


def _wires(k, n, kind, seed=0):
    """(k, W) uint8 JAX int4 wires of k random payloads with the kind's
    special entries in replica 1, and a (k,) mask with a zero."""
    rng = np.random.default_rng(seed * 1000 + n * 10 + k)
    xs = (rng.normal(size=(k, n))
          * 10.0 ** rng.uniform(-3, 0, size=(k, 1))).astype(np.float32)
    if kind == "nan":
        xs[1, 5 % n] = np.nan
    elif kind == "inf":
        xs[1, min(130, n - 1)] = np.inf
        xs[1, n // 3] = -np.inf
    elif kind == "negzero":
        xs[:, :min(n, 128)] = -0.0
    wires = np.stack([np.asarray(jops.wire_encode(jnp.asarray(x), "int4",
                                                  mode="ref")[0])
                      for x in xs])
    m = rng.uniform(0.1, 1.0, size=k).astype(np.float32)
    m[k - 1] = 0.0                            # a masked-out replica
    if kind == "nan_scale_masked":
        # the masked-out replica's first block scale is NaN on the wire
        cb, pad, _ = tref.wire_sections(n)
        wires[k - 1, cb + pad:cb + pad + 4] = np.frombuffer(
            np.float32(np.nan).tobytes(), np.uint8)
    return wires, m


def _decoded(wires, n):
    return np.stack([np.asarray(jops.wire_decode(jnp.asarray(w), n, "int4",
                                                 mode="ref"))
                     for w in wires])


def _assert_reduce_close(got, want, wires, m, denom, n):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    vals = _decoded(wires, n)
    with np.errstate(invalid="ignore"):
        scale = np.abs(m[:, None] * vals).sum(axis=0) / denom
    tol = REDUCE_RTOL * scale[~nan]
    assert np.all(np.abs(got[~nan] - want[~nan]) <= tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [2, 4])
def test_wire_reduce_matches_jax(k, n, kind):
    """``ops.wire_reduce`` of the port (auto: the kernel's plain version;
    ref: decode and weighted sum) against JAX's in ``ref`` and
    ``interpret`` mode (the Pallas reduce on the CPU), within the stated
    bound; the port's two modes bit for bit."""
    wires, m = _wires(k, n, kind)
    denom = np.float32(max(m.sum(), 1e-9))
    tw, tm, td = (torch.from_numpy(wires), torch.from_numpy(m),
                  torch.tensor(denom))
    auto = tops.wire_reduce(tw, n, "int4", tm, td, mode="auto").numpy()
    ref = tops.wire_reduce(tw, n, "int4", tm, td, mode="ref").numpy()
    np.testing.assert_array_equal(auto.view(np.uint32), ref.view(np.uint32))
    for mode in ("ref", "interpret"):
        want = jops.wire_reduce(jnp.asarray(wires), n, "int4",
                                jnp.asarray(m), jnp.asarray(denom),
                                mode=mode)
        _assert_reduce_close(auto, want, wires, m, denom, n)
    if kind in ("nan", "inf", "nan_scale_masked"):
        assert np.isnan(auto).any()
    if kind == "nan_scale_masked":
        assert np.isnan(auto[:min(n, 128)]).all()


@pytest.mark.parametrize("k", [2, 4])
def test_plain_reduce_matches_jax_ref(k):
    """``ref.unpack_dequantize_reduce`` on (k, R, 64) bytes, (k, R, 1)
    scales and a (k,) mask with a zero, against the JAX oracle of the
    same name, within the stated bound."""
    rng = np.random.default_rng(k)
    R = 37
    codes = rng.integers(-7, 8, size=(k, R * 128)).astype(np.int8)
    packed = np.stack([np.asarray(jref.pack_int4(jnp.asarray(c)))
                       for c in codes]).reshape(k, R, 64)
    scales = rng.uniform(1e-4, 1e-2, size=(k, R, 1)).astype(np.float32)
    m = np.array([0.7, 0.0, 1.0, 0.3][:k], np.float32)
    got = tref.unpack_dequantize_reduce(torch.from_numpy(packed),
                                        torch.from_numpy(scales),
                                        torch.from_numpy(m)).numpy()
    want = np.asarray(jref.unpack_dequantize_reduce(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(m)))
    scale = np.abs(m[:, None, None]
                   * codes.reshape(k, R, 128) * scales).sum(axis=0)
    assert np.all(np.abs(got - want) <= REDUCE_RTOL * scale)
    # the kernel's wire-level form agrees with it bit for bit
    cb = R * 64
    wires = np.concatenate([packed.reshape(k, -1).view(np.uint8),
                            scales.reshape(k, R).view(np.uint8).reshape(
                                k, -1)], axis=1)
    flat = TQ.unpack_dequantize_reduce(torch.from_numpy(wires), R * 128,
                                       torch.from_numpy(m)).numpy()
    assert cb % 4 == 0
    np.testing.assert_array_equal(flat.view(np.uint32),
                                  got.reshape(-1).view(np.uint32))


def _blocks(rows, kind, seed=0):
    rng = np.random.default_rng(seed + rows)
    x = (rng.normal(size=(rows, 128)) * 1e-2).astype(np.float32)
    if kind == "nan":
        x[0, 5] = np.nan
    elif kind == "inf":
        x[0, 7] = np.inf
        x[-1, 9] = -np.inf
    elif kind == "zeros":
        x[0] = 0.0
    elif kind == "negzero":
        x[0] = -0.0
        x[-1, ::3] = -0.0
    return x


def _codes_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                  np.asarray(want).view(np.uint8))


@pytest.mark.parametrize("kind", ["normal", "nan", "inf", "zeros",
                                  "negzero"])
@pytest.mark.parametrize("rows", [1, 3, 300])
def test_unfused_codecs_match_jax(rows, kind):
    """``quantize_int4`` (codes and scales), ``dequantize_int4``,
    ``pack_int4`` and ``unpack_int4`` through the port's kernel wrappers
    (their plain versions on CPU tensors) against the JAX Pallas kernels
    in ``interpret`` mode and the JAX oracles: bit for bit, NaN at the
    same places (a NaN quotient is code 0)."""
    x = _blocks(rows, kind)
    codes, scales = TQ.quantize_int4(torch.from_numpy(x))
    jc, js = jquant.quantize_int4(jnp.asarray(x), interpret=True)
    _codes_equal(codes.numpy(), jc)
    rc, rs = jref.quantize_int4(jnp.asarray(x))
    _codes_equal(codes.numpy(), rc)
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    deq = TQ.dequantize_int4(codes, scales).numpy()
    jd = np.asarray(jquant.dequantize_int4(jc, js, interpret=True))
    nan = np.isnan(jd)
    np.testing.assert_array_equal(np.isnan(deq), nan)
    np.testing.assert_array_equal(deq.view(np.uint32)[~nan],
                                  jd.view(np.uint32)[~nan])
    packed = TQ.pack_int4(codes)
    _codes_equal(packed.numpy(), jquant.pack_int4(jc, interpret=True))
    back = TQ.unpack_int4(packed)
    _codes_equal(back.numpy(), jquant.unpack_int4(
        jnp.asarray(packed.numpy()), interpret=True))
    _codes_equal(back.numpy(), codes.numpy())


@pytest.mark.parametrize("n", [1, 2, 127, 129, 1000])
def test_ops_pack_unpack_match_jax(n):
    """``ops.pack_int4`` and ``ops.unpack_int4`` (flat, ragged n; under
    ``auto`` the kernel wrappers over the codes padded to whole blocks)
    against JAX's in ``interpret`` and ``ref`` mode, byte for byte."""
    rng = np.random.default_rng(n)
    c = rng.integers(-7, 8, size=n).astype(np.int8)
    for tmode in ("auto", "ref"):
        p = tops.pack_int4(torch.from_numpy(c), mode=tmode)
        for jmode in ("interpret", "ref"):
            _codes_equal(p.numpy(), jops.pack_int4(jnp.asarray(c),
                                                   mode=jmode))
        u = tops.unpack_int4(p, n, mode=tmode)
        _codes_equal(u.numpy(), jops.unpack_int4(
            jnp.asarray(p.numpy()), n, mode="interpret"))
        _codes_equal(u.numpy(), c)


def test_kernel_wrappers_check_their_operands():
    """The new wrappers refuse what their kernels do not take, and count
    no launch on CPU tensors."""
    before = dict(TQ.launches)
    with pytest.raises(TypeError, match="R, 128"):
        TQ.quantize_int4(torch.zeros(4, 64))
    with pytest.raises(TypeError, match="int8"):
        TQ.pack_int4(torch.zeros(2, 128))
    with pytest.raises(ValueError, match="rows"):
        TQ.dequantize_int4(torch.zeros(2, 128, dtype=torch.int8),
                           torch.ones(3, 1))
    wires, m = _wires(2, 129, "normal")
    with pytest.raises(ValueError, match="take wires"):
        TQ.unpack_dequantize_reduce(torch.from_numpy(wires), 128,
                                    torch.from_numpy(m))
    with pytest.raises(TypeError, match="mask"):
        TQ.unpack_dequantize_reduce(torch.from_numpy(wires), 129,
                                    torch.ones(3))
    # a column slice of a larger gathered buffer is read in place
    big = torch.cat([torch.from_numpy(wires), torch.zeros(2, 8,
                                                          dtype=torch.uint8)],
                    dim=1)
    got = TQ.unpack_dequantize_reduce(big[:, :wires.shape[1]], 129,
                                      torch.from_numpy(m))
    want = tref.wire_reduce_int4(torch.from_numpy(wires), 129,
                                 torch.from_numpy(m))
    assert torch.equal(got, want)
    assert TQ.launches == before
