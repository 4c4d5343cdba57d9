"""Backend-stable float32 arithmetic (extractorb.frontend.fp) against
numpy's IEEE float32 and float64 references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extractorb.frontend import fp, orientation


def test_round_f32_keeps_products_out_of_fma(rng):
    a, b, c = (rng.random(50000).astype(np.float32) for _ in range(3))
    got = np.asarray(jax.jit(lambda a, b, c: fp.round_f32(a * b) + c)(a, b, c))
    np.testing.assert_array_equal(got, a * b + c)       # numpy: no FMA


def test_div_rn_is_correctly_rounded(rng):
    x = (rng.random((2, 50000)) * 10.0 ** rng.integers(-6, 7, (2, 50000))).astype(np.float32)
    ints = rng.integers(0, 2 ** 24, (2, 50000)).astype(np.float32)
    for a, b in (x, ints):
        num, den = np.minimum(a, b), np.maximum(a, b)
        den[den == 0] = 1
        got = np.asarray(jax.jit(fp.div_rn)(num, den))
        np.testing.assert_array_equal(got, num / den)
    edge = np.asarray(fp.div_rn(jnp.float32([0, 0, 7, 1e-30]), jnp.float32([1, 0, 7, 1e30])))
    np.testing.assert_array_equal(edge, [0, 0, 1, 0])


def test_sincos_within_one_ulp(rng):
    x = (rng.random(100000) * 2 * np.pi).astype(np.float32)
    s, c = (np.asarray(v) for v in jax.jit(fp.sincos)(x))
    for got, ref in ((s, np.sin(x.astype(np.float64))), (c, np.cos(x.astype(np.float64)))):
        ref32 = ref.astype(np.float32)
        ulp = np.abs(got.view(np.int32).astype(np.int64) - ref32.view(np.int32))
        assert ulp.max() <= 1
        assert (ulp == 0).mean() > 0.95


def test_fast_atan2_matches_scalar_formula(rng):
    """The angle equals the reference's scalar float32 formula (IEEE
    division, each product rounded) evaluated in numpy."""
    y, x = rng.integers(-2 ** 20, 2 ** 20, (2, 20000)).astype(np.float32)
    got = np.asarray(jax.jit(orientation.fast_atan2_deg)(y, x))
    ax, ay = np.abs(x), np.abs(y)
    big = ax >= ay
    den = np.where(big, ax, ay)
    c = np.where(big, ay, ax) / np.where(den == 0, 1, den)
    c2 = c * c
    a = (((orientation._P7 * c2 + orientation._P5) * c2 + orientation._P3) * c2
         + orientation._P1) * c
    a = np.where(big, a, np.float32(90) - a)
    a = np.where(x < 0, np.float32(180) - a, a)
    a = np.where(y < 0, np.float32(360) - a, a)
    np.testing.assert_array_equal(got, a.astype(np.float32))


@pytest.mark.gpu
def test_backends_agree_on_gpu(gpu_device, rng):
    """fp's operations give the same bits on the GPU as on the CPU of
    the same process; the plain XLA operations they replace need not
    (how many of them differ is printed)."""
    n = 200000
    a, b, c = (rng.random(n).astype(np.float32) for _ in range(3))
    x = (rng.random(n) * 2 * np.pi).astype(np.float32)
    cases = {   # name: (plain XLA, backend-stable, arguments)
        "division": (lambda u, v: u / v, fp.div_rn,
                     (np.minimum(a, b), np.maximum(a, b) + np.float32(1e-3))),
        "product+add": (lambda u, v, w: u * v + w,
                        lambda u, v, w: fp.round_f32(u * v) + w, (a, b, c)),
        "cos": (jnp.cos, lambda u: fp.sincos(u)[1], (x,)),
        "sin": (jnp.sin, lambda u: fp.sincos(u)[0], (x,)),
    }

    def bits(dev, f, args):
        out = jax.jit(f)(*(jax.device_put(v, dev) for v in args))
        return np.asarray(out).view(np.int32)

    cpu = jax.devices("cpu")[0]
    for name, (plain, stable, args) in cases.items():
        differ = int((bits(gpu_device, plain, args) != bits(cpu, plain, args)).sum())
        print(f"plain {name}: {differ} of {n} differ between GPU and CPU")
        np.testing.assert_array_equal(bits(gpu_device, stable, args), bits(cpu, stable, args))
