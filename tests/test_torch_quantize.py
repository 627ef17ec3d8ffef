"""K6, the §7 uniform quantizer, on the CPU: the port's ``quantize_tensor``
(whose CPU path is the plain version ``_quantize_plain``) and
``dequantize_tensor`` against the reference's interpret-mode Pallas kernel
and its jnp forms, on the same numpy inputs.

Everything here is exact: codes, reconstructions, ``lo`` and ``step`` must
be array-equal to the reference's.  The reference's kernel, run through
XLA, multiplies by the float32 reciprocal of ``step`` (a division by a
compile-time constant) and, with dither, fuses that product with the
dither's add; its reconstruction is one fused multiply-add.  Its jnp
oracle ``quantize_reference`` divides instead, and its
``dequantize_tensor`` rounds the product and the sum apart.  The large
cases below put values on bin edges, where those forms part.
"""
import fractions

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize.ops import dequantize_tensor as ref_dequantize
from repro.kernels.quantize.ops import quantize_tensor as ref_quantize
from repro.kernels.quantize.ref import quantize_reference as ref_oracle
from repro_torch.kernels.quantize import quantize as qz
from repro_torch.kernels.quantize.ops import dequantize_tensor, quantize_tensor
from repro_torch.kernels.quantize.ref import quantize_reference

DITHERS = [(False, 0), (True, 0), (True, 7), (True, -1), (True, 2**31 - 1)]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _equal_to_reference(x, dtype, bits, dither, seed):
    jx, tx = _pair(x, dtype)
    q, recon, (lo, step) = ref_quantize(jx, bits, dither, seed,
                                        interpret=True)
    tq, trecon, (tlo, tstep) = quantize_tensor(tx, bits, dither, seed)
    assert (tlo, tstep) == (lo, step)
    assert tq.dtype == torch.int32 and trecon.dtype == torch.float32
    assert tq.shape == tx.shape == trecon.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(trecon.numpy(), np.asarray(recon))
    np.testing.assert_array_equal(
        dequantize_tensor(tq, tlo, tstep).numpy(),
        np.asarray(ref_dequantize(q, lo, step)))
    return tq, trecon, tlo, tstep


@pytest.mark.parametrize("dither,seed", DITHERS)
@pytest.mark.parametrize("bits", [2, 4, 8, 12])
@pytest.mark.parametrize("shape", [(1000,), (64, 100), (3, 7, 11)])
def test_quantize_tensor_equals_interpret_kernel(shape, bits, dither, seed):
    """The reference's shapes (``tests/test_kernels.py``) and 12 bits, with
    and without dither; n < 256 and n not a multiple of 256 among them."""
    x = (np.random.default_rng(bits).standard_normal(shape) * 3).astype(
        np.float32)
    tq, trecon, lo, step = _equal_to_reference(x, "float32", bits, dither,
                                               seed)
    err = float((trecon - torch.from_numpy(x)).abs().max())
    assert err <= (step if dither else step / 2) + 1e-4


@pytest.mark.parametrize("dither,seed", DITHERS)
@pytest.mark.parametrize("bits,dtype", [(8, "bfloat16"), (12, "float32"),
                                        (12, "bfloat16")])
def test_bin_edges_equal_interpret_kernel(bits, dtype, dither, seed):
    """200,000 values, where some land on bin edges: bf16 values often do
    at 8 bits.  A true division would give other codes there."""
    x = (np.random.default_rng(4).standard_normal(200_000) * 3).astype(
        np.float32)
    _equal_to_reference(x, dtype, bits, dither, seed)


@pytest.mark.parametrize("bits,dtype", [(8, "bfloat16"), (12, "float32")])
def test_bin_edges_follow_the_kernel_not_the_oracle(bits, dtype):
    """On these values the kernel's product with the reciprocal and the
    oracle's division give other codes (157 of 200,000 bf16 values at 8
    bits, 10 float32 values at 12 bits); the port's ``quantize`` follows
    the kernel and its twin ``quantize_reference`` the oracle."""
    x = (np.random.default_rng(4).standard_normal(200_000) * 3).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    tq, _, (lo, step) = quantize_tensor(tx, bits)
    oq, orecon = quantize_reference(tx, lo, step, 1 << bits)
    rq, rrecon = ref_oracle(jx, lo, step, 1 << bits)
    np.testing.assert_array_equal(oq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(orecon.numpy(), np.asarray(rrecon))
    assert int((oq != tq).sum()) > 0


def test_reference_recon_and_dequantize_differ_in_the_last_bits():
    """A condition of the reference that the port keeps: its kernel's
    ``recon`` is one fused multiply-add, its ``dequantize_tensor`` rounds
    the product and the sum apart, so the two differ in the last bits on
    most elements (156,215 of these 200,000 at 8 bits), by at most half an
    ulp of the product plus one ulp of the result; the port's ``recon``
    and ``dequantize_tensor`` equal the reference's own (above), so they
    differ in the same places."""
    x = (np.random.default_rng(4).standard_normal(200_000) * 3).astype(
        np.float32)
    q, recon, (lo, step) = ref_quantize(jnp.asarray(x), 8, interpret=True)
    deq = np.asarray(ref_dequantize(q, lo, step))
    recon = np.asarray(recon)
    differ = recon != deq
    assert 0 < int(differ.sum()) < x.size
    prod = (np.asarray(q, np.float32) + np.float32(0.5)) * np.float32(step)
    assert np.all(np.abs(recon - deq)
                  <= np.spacing(np.abs(prod)) / 2 + np.spacing(np.abs(recon)))
    tq, trecon, _ = quantize_tensor(torch.from_numpy(x), 8)
    tdeq = dequantize_tensor(tq, lo, step)
    np.testing.assert_array_equal((trecon != tdeq).numpy(), differ)


@pytest.mark.parametrize("bits", [2, 8])
def test_oracle_twin_with_dither_equals_reference_oracle(bits):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((50, 40)) * 2).astype(np.float32)
    d = (rng.random((50, 40)) - 0.5).astype(np.float32)
    lo, step = float(x.min()), (float(x.max()) - float(x.min())) / (1 << bits)
    q, recon = quantize_reference(torch.from_numpy(x), lo, step, 1 << bits,
                                  torch.from_numpy(d))
    rq, rrecon = ref_oracle(jnp.asarray(x), lo, step, 1 << bits,
                            jnp.asarray(d))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(recon.numpy(), np.asarray(rrecon))


def test_constant_tensor_uses_the_step_floor():
    x = np.full((300,), 0.5, np.float32)
    for dither in (False, True):
        tq, trecon, lo, step = _equal_to_reference(x, "float32", 8, dither,
                                                   0)
        assert step == 1e-30 and lo == 0.5
        assert int(tq.abs().sum()) == 0
        assert torch.equal(trecon, torch.from_numpy(x))


def test_dither_changes_codes_but_bounded_error():
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal(512).astype(np.float32))
    q0, _, (_, step) = quantize_tensor(x, 6, dither=False)
    q1, recon1, _ = quantize_tensor(x, 6, dither=True, seed=7)
    assert not torch.equal(q0, q1)
    assert float((recon1 - x).abs().max()) <= step + 1e-4


def test_distortion_scales_as_2_pow_minus_b():
    """§7: quantization distortion variance ~ step^2/12 ~ 4^-b."""
    x = torch.from_numpy(
        np.random.default_rng(2).random(20000).astype(np.float32))
    errs = []
    for bits in (4, 6, 8):
        _, recon, (_, step) = quantize_tensor(x, bits)
        errs.append(float(((recon - x) ** 2).mean()))
        assert errs[-1] == pytest.approx(step**2 / 12, rel=0.1)
    assert errs[0] / errs[1] == pytest.approx(16, rel=0.2)
    assert errs[1] / errs[2] == pytest.approx(16, rel=0.2)


def _round_f32(value: fractions.Fraction) -> float:
    """``value`` rounded to the nearest float32, ties to even, exactly."""
    f = np.float32(float(value))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(fractions.Fraction(float(c)) - value)
        even = (int(np.array(c).view(np.int32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return float(best[1])


def test_fma_is_one_rounding():
    """``_fma_f32`` against exact rational arithmetic.  The first half of
    the cases put the exact sum just below the midpoint between ``c`` (of
    odd significand) and its upper neighbour: a float64 sum rounds onto the
    midpoint, and its rounding to float32 then goes up, where one rounding
    goes down.  The second half are random (q + 0.5) * step + lo."""
    rng = np.random.default_rng(5)
    n = 2000
    c = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-8, 8, n)).astype(
        np.float32)
    c = (c.view(np.int32) | 1).view(np.float32)
    m = rng.integers(1, 256, n)
    a = (1 + m * 2.0**-23).astype(np.float32)
    b = (np.spacing(c) / 2 * (1 - m * 2.0**-23)).astype(np.float32)
    lo = (rng.standard_normal(n) * 4).astype(np.float32)
    a = np.concatenate(
        [a, (rng.integers(0, 4096, n) + 0.5).astype(np.float32)])
    b = np.concatenate([b, (rng.random(n) * 0.01).astype(np.float32)])
    c = np.concatenate([c, lo])
    got = qz._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    want = np.array([
        _round_f32(fractions.Fraction(float(a[i]))
                   * fractions.Fraction(float(b[i]))
                   + fractions.Fraction(float(c[i])))
        for i in range(len(c))], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert int((twice[:n] != want[:n]).sum()) > 0  # the cases bite


def test_quantize_checks_its_arguments():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="int32"):
        quantize_tensor(x, 8, dither=True, seed=2**31)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        qz.quantize(torch.zeros(8), 0.0, 1.0, 4)
    with pytest.raises(TypeError):
        qz.quantize(np.zeros((4, 8), np.float32), 0.0, 1.0, 4)


def test_launch_refuses_cpu_tensors():
    qz.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        qz._launch_quantize(torch.zeros((4, 8)), 0.0, 1.0, 4)
    assert qz.LAUNCHES == {"quantize": 0}
