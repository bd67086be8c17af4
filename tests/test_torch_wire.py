"""The port's packed wire codecs (``kernels/ops.py`` ``wire_encode``,
``wire_decode``; ``kernels/ref.py`` ``pack_int4``, ``unpack_int4``,
``quantize_pack_int4``, ``unpack_dequantize_int4``) against the JAX
package's, on the same numpy inputs.

The int4 wire must equal JAX's byte for byte, in the JAX ``ref`` mode
(the unfused codec pieces) and in ``interpret`` mode (the Pallas fused
sender and receiver run on the CPU), and its decode bit for bit: on
ragged lengths (n ≡ 1, 2, 3 mod 4, n < 128, a block straddling the end),
and on blocks holding a NaN (its codes are round(x) clipped, 0 at the
NaN, its scale NaN), ±inf (scale inf, codes 0), only zeros (scale 0,
codes 0) and −0.0. Such blocks decode to all NaN, so a diverged worker
poisons the global as in JAX. NaN payload bits are not compared in
decoded floats (only where NaNs are); the wire's scale bytes are.
The port runs its plain versions here (CPU tensors); the CUDA kernels are
held to them bit for bit in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 17.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)
SIZES = [1, 2, 3, 127, 128, 129, 300, 1000, 4099]
KINDS = ["normal", "nan", "inf", "zeros", "negzero"]


def make_x(n, kind, seed=0):
    """float32 (n,): normal values of a gradient's magnitude, with the
    ``kind``'s special entries."""
    rng = np.random.default_rng(seed * 1000 + n)
    x = (rng.normal(size=n) * 1e-2).astype(np.float32)
    if kind == "nan":
        x[5 % n] = np.nan                     # entry 5 of block 0
    elif kind == "inf":
        x[min(130, n - 1)] = np.inf
        x[n // 3] = -np.inf
    elif kind == "zeros":
        x[:min(n, 128)] = 0.0                 # block 0 all zero
        x[n - 1] = 0.0
    elif kind == "negzero":
        x[:min(n, 128)] = -0.0                # block 0 all −0.0
        x[128::3] = -0.0
    return x


def _floats_equal(got, want):
    """Bit for bit where ``want`` is not NaN, NaN at the same places."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan],
                                  want.view(np.uint32)[~nan])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_int4_wire_bytes_equal_jax(n, kind):
    """The port's wire (plain, through ``auto`` on CPU tensors and through
    ``ref``) byte for byte against JAX's in ``ref`` and ``interpret``
    mode; its decode bit for bit against JAX's decode of the same bytes;
    its local against JAX's (−0.0 may keep its sign: the kernel's local
    is clip(q)·scale, as the Pallas sender's)."""
    x = make_x(n, kind)
    jwire = {m: np.asarray(jops.wire_encode(jnp.asarray(x), "int4",
                                            mode=m)[0])
             for m in ("ref", "interpret")}
    np.testing.assert_array_equal(jwire["ref"], jwire["interpret"])
    jlocal = np.asarray(jops.wire_encode(jnp.asarray(x), "int4",
                                         mode="interpret")[1])
    for mode in ("auto", "ref"):
        wire, local = tops.wire_encode(torch.from_numpy(x), "int4",
                                       mode=mode)
        assert wire.dtype == torch.uint8
        assert wire.numel() == tops.wire_elems(n, "int4")
        np.testing.assert_array_equal(wire.numpy(), jwire["ref"])
        _floats_equal(local.numpy(), jlocal)
    jdec = np.asarray(jops.wire_decode(jnp.asarray(jwire["ref"]), n,
                                       "int4", mode="ref"))
    for mode in ("auto", "ref"):
        got = tops.wire_decode(torch.from_numpy(jwire["ref"].copy()), n,
                               "int4", mode=mode)
        _floats_equal(got.numpy(), jdec)
    if kind in ("nan", "inf"):
        assert np.isnan(jdec[:min(n, 128)]).all() or kind == "inf"
        blocks = {i // 128 for i in np.flatnonzero(~np.isfinite(x))}
        for b in blocks:
            assert np.isnan(jdec[b * 128:(b + 1) * 128]).all()


def test_nan_block_codes():
    """A NaN at entry 5 of block 0: the block's code bytes are round(x)
    clipped (a NaN scale divides by 1) with 0 at the NaN: here 9.0 gives
    7, so 0x77 with 0x07 at byte 2; its scale is NaN; the whole block
    decodes to NaN; the other blocks are untouched."""
    x = np.full(300, 9.0, np.float32)
    x[5] = np.nan
    wire, _ = tops.wire_encode(torch.from_numpy(x), "int4")
    w = wire.numpy()
    assert list(w[:4]) == [0x77, 0x77, 0x07, 0x77]
    scales = w[152:].view(np.float32)
    assert np.isnan(scales[0]) and scales[1] == np.float32(9.0) * \
        np.float32(tref.INV_INT4_LEVELS)
    dec = tops.wire_decode(wire, 300, "int4").numpy()
    assert np.isnan(dec[:128]).all() and np.isfinite(dec[128:]).all()
    np.testing.assert_array_equal(
        w, np.asarray(jops.wire_encode(jnp.asarray(x), "int4",
                                       mode="interpret")[0]))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 129, 4099])
def test_ragged_tail_padding_and_scales(n):
    """ceil(n/2) code bytes, an odd n's last byte with high nibble 0, the
    padding bytes 0, the scales right after the padding."""
    x = np.full(n, -1.0, np.float32)
    wire = tops.wire_encode(torch.from_numpy(x), "int4")[0].numpy()
    cb, pad, rows = tref.wire_sections(n)
    assert wire.size == cb + pad + 4 * rows
    assert cb + pad == -(-n // 2) + (-(-(-n // 2)) % 4)
    if n % 2:
        assert wire[cb - 1] >> 4 == 0
    assert (wire[cb:cb + pad] == 0).all()
    np.testing.assert_array_equal(
        wire[cb + pad:].view(np.float32),
        np.full(rows, np.float32(1.0) * np.float32(tref.INV_INT4_LEVELS)))


@pytest.mark.parametrize("kind", ["normal", "nan", "inf", "negzero"])
@pytest.mark.parametrize("n", [1, 129, 1000])
def test_bf16_wire_equal_jax(n, kind):
    """bf16's wire is the bf16 bits as uint16, equal to JAX's but for a
    NaN's bits (XLA's cast writes the canonical 0x7fc0, PyTorch's keeps
    another NaN): NaN at the same places; the decode widens exactly."""
    x = make_x(n, kind)
    jw, jl = jops.wire_encode(jnp.asarray(x), "bfloat16", mode="ref")
    wire, local = tops.wire_encode(torch.from_numpy(x), "bfloat16")
    assert wire.dtype == torch.uint16 == tops.wire_dtype("bfloat16")
    as_f32 = lambda w: (np.asarray(w).astype(np.uint32) << 16).view(
        np.float32)
    _floats_equal(as_f32(wire.numpy()), as_f32(jw))
    _floats_equal(local.numpy(), np.asarray(jl))
    _floats_equal(tops.wire_decode(wire, n, "bfloat16").numpy(),
                  np.asarray(jops.wire_decode(jw, n, "bfloat16")))
    assert tops.wire_elems(n, "bfloat16") == jops.wire_elems(n, "bfloat16")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows", [1, 3])
def test_plain_fused_codecs_equal_jax_ref(rows, kind):
    """``ref.quantize_pack_int4`` and ``unpack_dequantize_int4`` on (R, 128)
    blocks against JAX ``ref``'s: packed bytes and scales bit for bit, the
    local values equal (−0.0 == 0.0), the decode bit for bit."""
    x = make_x(rows * 128, kind).reshape(rows, 128)
    jp, js, jl = jref.quantize_pack_int4(jnp.asarray(x))
    tp, ts, tl = tref.quantize_pack_int4(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jd = jref.unpack_dequantize_int4(jp, js)
    td = tref.unpack_dequantize_int4(tp, ts)
    _floats_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n", [1, 2, 7, 128, 301])
def test_pack_unpack_equal_jax_ref(n):
    """``ref.pack_int4`` / ``unpack_int4`` against JAX's on codes in
    [-7, 7], and the round trip is the identity."""
    rng = np.random.default_rng(n)
    codes = rng.integers(-7, 8, size=n).astype(np.int8)
    jp = np.asarray(jref.pack_int4(jnp.asarray(codes)))
    tp = tref.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tref.unpack_int4(tp, n).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jref.unpack_int4(jnp.asarray(jp), n)), codes)


@pytest.mark.parametrize("n", SIZES + [217_012_096])
def test_wire_elems_equal_transport_bytes(n):
    assert tops.wire_elems(n, "int4") == tops.transport_bytes(
        n, "int4", packed=True) == jops.wire_elems(n, "int4")
    cb, pad, rows = tref.wire_sections(n)
    assert cb + pad + 4 * rows == tops.wire_elems(n, "int4")


def test_wire_elems_of_diloco_150m():
    """One diloco_150m payload: 115,287,676 bytes against 868,048,384 of
    float32 (7.53x fewer)."""
    assert tops.wire_elems(217_012_096, "int4") == 115_287_676
    assert tops.transport_bytes(217_012_096, "float32") == 868_048_384


def test_kernel_wrappers_on_cpu_and_checks():
    """The wrappers run the plain versions on CPU tensors (no local when
    none is asked for), check the wire's dtype and size, and
    ``kernel_mode='kernel'`` refuses CPU tensors."""
    x = torch.from_numpy(make_x(300, "normal"))
    want, want_local = tref.wire_encode_int4(x)
    wire = torch.empty(tops.wire_elems(300, "int4"), dtype=torch.uint8)
    assert TQ.quantize_pack_int4(x, wire) is wire
    assert torch.equal(wire, want)
    local = torch.empty(300)
    TQ.quantize_pack_int4(x, wire, local)
    assert torch.equal(local, want_local)
    assert torch.equal(TQ.unpack_dequantize_int4(wire, 300),
                       tref.wire_decode_int4(want, 300))
    assert tops.wire_encode(x, "int4", with_local=False)[1] is None
    with pytest.raises(ValueError, match="bytes"):
        TQ.quantize_pack_int4(x, torch.empty(10, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        TQ.unpack_dequantize_int4(wire.view(torch.int8), 300)
    with pytest.raises(ValueError, match="CUDA"):
        tops.wire_encode(x, "int4", mode="kernel")
    with pytest.raises(ValueError, match="packed wire"):
        tops.wire_encode(x, "float32")
    assert TQ.launches["quantize_pack_int4"] == 0
    assert TQ.launches["unpack_dequantize_int4"] == 0
