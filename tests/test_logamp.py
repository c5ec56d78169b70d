"""Unit tests for signed log-amplitude arithmetic."""

import numpy as np
import jax.numpy as jnp
import pytest

from cgs_vmc_jax.ops import logamp


def _amp(values):
    return logamp.from_value(jnp.asarray(values, jnp.float32))


@pytest.mark.parametrize('a,b', [
    ([1.5, -2.0, 0.3], [0.5, 0.1, -0.2]),
    ([1e10, -1e-10, 2.0], [1e10, 1e-10, -1.0]),
])
def test_add_matches_dense(a, b):
    out = logamp.add(_amp(a), _amp(b))
    np.testing.assert_allclose(
        np.asarray(logamp.to_value(out)),
        np.asarray(a, np.float64) + np.asarray(b, np.float64),
        rtol=1e-5, atol=1e-7)


def test_sub_cancellation():
    a = _amp([3.0, -1.0])
    b = _amp([3.0, -1.0])
    out = logamp.sub(a, b)
    assert np.all(np.asarray(out.sign) == 0.0)


def test_mul_scale():
    a = _amp([2.0, -3.0])
    out = logamp.scale(logamp.mul(a, a), -0.5)
    np.testing.assert_allclose(
        np.asarray(logamp.to_value(out)), [-2.0, -4.5], rtol=1e-6)


def test_sum_terms():
    signs = jnp.asarray([[1.0, -1.0, 1.0], [1.0, 1.0, 1.0]])
    logs = jnp.log(jnp.asarray([[1.0, 2.0, 4.0], [1.0, 1.0, 1.0]]))
    out = logamp.sum_terms(signs, logs, axis=-1)
    np.testing.assert_allclose(
        np.asarray(logamp.to_value(out)), [3.0, 3.0], rtol=1e-6)


def test_overflow_free_ratio():
    # Amplitude scales far beyond float range must still give finite ratios.
    num = logamp.LogAmp(jnp.asarray([1.0]), jnp.asarray([500.0]))
    den = logamp.LogAmp(jnp.asarray([-1.0]), jnp.asarray([499.0]))
    r = logamp.ratio(num, den)
    np.testing.assert_allclose(np.asarray(r), [-np.e], rtol=1e-6)


def test_apply_activation_exp_is_identity_in_log_space():
    pre = jnp.asarray([1e4, -1e4])  # would overflow raw exp
    amp = logamp.apply_activation(pre, 'exp')
    assert np.all(np.asarray(amp.sign) == 1.0)
    np.testing.assert_array_equal(np.asarray(amp.log), np.asarray(pre))


def test_apply_activation_signed():
    pre = jnp.asarray([0.5, 2.0])  # cos: positive then negative
    amp = logamp.apply_activation(pre, 'cos')
    values = np.asarray(logamp.to_value(amp))
    np.testing.assert_allclose(values, np.cos(np.asarray(pre)), rtol=1e-6)
