"""The port's low-precision transport (``fake_quant``, int4 and bf16)
against the JAX package's.

On the CPU the kernel wrapper runs its plain version; it is held bit for
bit to the JAX ``ops.quant_roundtrip`` in ``interpret`` mode (the Pallas
kernel it ports) and in ``ref`` mode (the jnp oracle): the scale is one
float32 multiply of an exact max, the division is IEEE and the rounding
half to even, so no order of operations can move a bit. One difference
between the two JAX modes: the oracle passes the codes through int8,
which turns a code of −0 (a small negative entry, or −0.0 itself) into
+0, where the Pallas kernel, and the port, keep −0.0. Against ``ref`` the
bits are compared with zeros' signs cleared (+0 == −0 as numbers). A
block holding a NaN or an infinity comes out all NaN in both packages;
NaN positions are compared, their payloads are not. The CUDA kernel is
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
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
DTYPES = ["int4", "bfloat16"]
# aligned, ragged (n % 128 != 0) and multi-dim shapes
SHAPES = [(128,), (1000,), (7, 300), (3, 5, 128), (1,), (129,)]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    scale = np.float32(10.0) ** rng.integers(-4, 2, size=shape)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_bits_equal(got, want, *, signed_zeros=True):
    """Bit for bit where not NaN; NaN at the same positions.
    ``signed_zeros=False`` clears the sign of zeros first (x + 0 is +0 for
    x = −0 and x itself otherwise)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not signed_zeros:
        got, want = got + np.float32(0), want + np.float32(0)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _jax(x, dtype, mode, stacked=False):
    fn = lambda v: jops.quant_roundtrip(v, dtype, mode=mode)
    if stacked:
        import jax
        return np.asarray(jax.vmap(fn)(jnp.asarray(x)))
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fake_quant_plain_matches_jax(shape, dtype):
    x = _x(shape, len(shape) * 1000 + shape[-1])
    got = tops.quant_roundtrip(torch.from_numpy(x), dtype).numpy()
    _assert_bits_equal(got, _jax(x, dtype, "ref"), signed_zeros=False)
    _assert_bits_equal(got, _jax(x, dtype, "interpret"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 300), (3, 4, 40), (2, 128), (4, 1)])
def test_stacked_fake_quant_matches_jax_vmap(shape, dtype):
    """Blocks restart at each replica (the JAX vmap over k), also where a
    replica's size is not a multiple of 128."""
    x = _x(shape, shape[0] * 7 + shape[-1])
    got = tops.quant_roundtrip(torch.from_numpy(x), dtype,
                               stacked=True).numpy()
    _assert_bits_equal(got, _jax(x, dtype, "ref", stacked=True),
                       signed_zeros=False)
    _assert_bits_equal(got, _jax(x, dtype, "interpret", stacked=True))
    whole = tops.quant_roundtrip(torch.from_numpy(x), dtype).numpy()
    if dtype == "int4" and np.prod(shape[1:]) % 128:
        assert not np.array_equal(got, whole)


def _special_blocks():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    x[0, 3] = np.nan                  # a NaN block
    x[1, 100] = np.inf                # +inf
    x[2, 0] = -np.inf                 # -inf
    x[3] = 0.0                        # all zeros
    x[4] = -0.0                       # all negative zeros
    x[5, ::2] = -0.0                  # -0.0 among values
    x[6, 5] = np.float32(3.5) * np.float32(1.0 / 7.0)   # finite neighbours
    return x.reshape(-1)[:1000]       # a ragged tail block too


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_inf_and_zero_blocks_match_jax(dtype):
    """A NaN or an infinity makes its whole int4 block NaN (not only its
    own entry), zeros stay zeros with their signs, and the other blocks
    are untouched by them."""
    x = _special_blocks()
    got = tops.quant_roundtrip(torch.from_numpy(x), dtype).numpy()
    _assert_bits_equal(got, _jax(x, dtype, "ref"), signed_zeros=False)
    _assert_bits_equal(got, _jax(x, dtype, "interpret"))
    blocks = got[:896].reshape(7, 128)
    if dtype == "int4":
        assert np.isnan(blocks[:3]).all()
        assert np.isfinite(blocks[3:]).all()
    assert np.array_equal(np.signbit(blocks[4]), np.ones(128, bool))
    assert (blocks[3:5] == 0).all()


def test_int4_codes_match_jax():
    """``quantize_int4``/``dequantize_int4`` (the unfused oracles) bit for
    bit, codes included; ``fake_quant`` is their composition on finite
    blocks."""
    x = _x((40, 128), 3)
    x[7] = 0.0
    codes, scales = tref.quantize_int4(torch.from_numpy(x))
    jc, js = jref.quantize_int4(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    _assert_bits_equal(scales.numpy(), np.asarray(js))
    deq = tref.dequantize_int4(codes, scales)
    _assert_bits_equal(deq.numpy(), np.asarray(jref.dequantize_int4(jc,
                                                                    js)))
    _assert_bits_equal(tref.fake_quant(torch.from_numpy(x), "int4").numpy(),
                       deq.numpy(), signed_zeros=False)
    assert int(codes.abs().max()) == 7


@pytest.mark.parametrize("packed", [False, True])
def test_transport_bytes_match_jax(packed):
    for n in (0, 1, 2, 3, 127, 128, 129, 255, 256, 1000, 4099, 896 * 3584):
        for dtype in ("float32", "bfloat16", "int4"):
            assert tops.transport_bytes(n, dtype, packed=packed) == \
                jops.transport_bytes(n, dtype, packed=packed), (n, dtype)
    assert tops.TRANSPORT_BYTES_PER_ELEM == jops.TRANSPORT_BYTES_PER_ELEM
    assert (tops.QUANT_BLOCK, tops.WIRE_ALIGN) == (jops.QUANT_BLOCK,
                                                   jops.WIRE_ALIGN)
    assert tref.INV_INT4_LEVELS == jref.INV_INT4_LEVELS
    with pytest.raises(ValueError):
        tops.transport_bytes(10, "int8")


def test_wrapper_forms_and_checks():
    """``out=`` writes in place; float32 is the identity; the tree form
    quantizes each leaf whole; the plain versions launch nothing; bad
    operands are refused."""
    before = dict(TQ.launches)
    x = torch.from_numpy(_x((3, 200), 9))
    want = tops.quant_roundtrip(x, "int4", stacked=True)
    y = x.clone()
    assert tops.quant_roundtrip(y, "int4", stacked=True, out=y) is y
    assert torch.equal(y, want)
    assert tops.quant_roundtrip(x, "float32") is x
    t = tops.quant_roundtrip_tree({"a": x, "b": {"c": x[0]}}, "bfloat16")
    assert torch.equal(t["b"]["c"], x[0].to(torch.bfloat16).float())
    for mode in ("auto", "ref"):
        assert torch.equal(tops.quant_roundtrip(x, "int4", mode=mode,
                                                stacked=True), want)
    assert TQ.launches == before
    with pytest.raises(TypeError):
        TQ.fake_quant(x.double(), "int4")
    with pytest.raises(ValueError):
        TQ.fake_quant(x, "int8")
    with pytest.raises(ValueError):
        TQ.fake_quant(x, "int4", rows=7)
    with pytest.raises(ValueError, match="CUDA"):
        tops.quant_roundtrip(x, "int4", mode="kernel")
