"""Wavefunction protocol: pure-function ansatzes over pytree parameters.

Functional redesign of the reference's Sonnet module hierarchy
(cgs_vmc/wavefunctions.py:21-297).  Differences that define the framework:

 * amplitudes are signed log values ``LogAmp(sign, log)`` — psi = sign·e^log —
   so the exp-norm-shift subsystem (cgs_vmc/wavefunctions.py:206-288,
   normalizer.py) does not exist here;
 * parameters are explicit pytrees; ``init(key)`` creates them and
   ``apply(params, configs)`` is a pure function of them, so the reference's
   graph-introspection machinery (`get_trainable_variables`,
   `__deepcopy__` via `inspect`, `module_transfer_ops`,
   cgs_vmc/wavefunctions.py:167-204,300-325) collapses to ordinary pytree
   assignment — an SWO supervisor refresh is ``omega_params = params``;
 * wavefunction algebra (`__add__`/`__mul__`/`__sub__`,
   cgs_vmc/wavefunctions.py:61-165) is implemented with sign-aware
   logsumexp combinators.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax

from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


Params = Any  # nested dict pytree of jnp arrays


class Wavefunction:
    """Base class: static hyperparameters + pure init/apply.

    Subclasses set static attributes in ``__init__`` and implement:
      init(key) -> Params
      apply(params, configs) -> LogAmp     # configs: [batch, n_sites] ±1
    """

    name: str = 'wavefunction'

    def init(self, key: jax.Array) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        raise NotImplementedError

    def __call__(self, params: Params, configs: jax.Array) -> LogAmp:
        return self.apply(params, configs)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'Wavefunction':
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Wavefunction algebra (log-domain; reference wavefunctions.py:61-165).
    # ------------------------------------------------------------------

    def __add__(self, other: 'Wavefunction') -> 'Wavefunction':
        return SumOfWavefunctions(self, other)

    def __sub__(self, other: 'Wavefunction') -> 'Wavefunction':
        return SumOfWavefunctions(self, other, sign_b=-1.0)

    def __mul__(self, other) -> 'Wavefunction':
        if isinstance(other, Wavefunction):
            return ProductOfWavefunctions(self, other)
        return ScaledWavefunction(self, float(other))

    __rmul__ = __mul__


class SumOfWavefunctions(Wavefunction):
    """psi_a + sign_b * psi_b via cancellation-safe signed logsumexp."""

    def __init__(self, wf_a: Wavefunction, wf_b: Wavefunction,
                 sign_b: float = 1.0, name: str = 'sum_of_wavefunctions'):
        self.name = name
        self._wf_a = wf_a
        self._wf_b = wf_b
        self._sign_b = sign_b

    def init(self, key: jax.Array) -> Params:
        key_a, key_b = jax.random.split(key)
        return {'a': self._wf_a.init(key_a), 'b': self._wf_b.init(key_b)}

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        amp_a = self._wf_a.apply(params['a'], configs)
        amp_b = self._wf_b.apply(params['b'], configs)
        return logamp.add(
            amp_a, LogAmp(self._sign_b * amp_b.sign, amp_b.log))


class ProductOfWavefunctions(Wavefunction):
    """psi_a * psi_b: signs multiply, logs add."""

    def __init__(self, wf_a: Wavefunction, wf_b: Wavefunction,
                 name: str = 'product_of_wavefunctions'):
        self.name = name
        self._wf_a = wf_a
        self._wf_b = wf_b

    def init(self, key: jax.Array) -> Params:
        key_a, key_b = jax.random.split(key)
        return {'a': self._wf_a.init(key_a), 'b': self._wf_b.init(key_b)}

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        amp_a = self._wf_a.apply(params['a'], configs)
        amp_b = self._wf_b.apply(params['b'], configs)
        return logamp.mul(amp_a, amp_b)


class ScaledWavefunction(Wavefunction):
    """psi * c for a real constant c (reference's `wf * float`)."""

    def __init__(self, wf: Wavefunction, factor: float,
                 name: str = 'scaled_wavefunction'):
        self.name = name
        self._wf = wf
        self._factor = factor

    def init(self, key: jax.Array) -> Params:
        return self._wf.init(key)

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        return logamp.scale(self._wf.apply(params, configs), self._factor)


class TransformedWavefunction(Wavefunction):
    """O|psi> wrapped as a wavefunction (reference operators.py:90-125).

    `transform(params, configs) -> LogAmp` is a closure over the operator;
    built by `Operator.apply`.
    """

    def __init__(self, transform: Callable[[Params, jax.Array], LogAmp],
                 wf: Wavefunction, name: str = 'transformed_wavefunction'):
        self.name = name
        self._wf = wf
        self._transform = transform

    def init(self, key: jax.Array) -> Params:
        return self._wf.init(key)

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        return self._transform(params, configs)


# Registry of concrete ansatz classes; populated by models/__init__.py
# (reference WAVEFUNCTION_TYPES, cgs_vmc/wavefunctions.py:1199-1211).
WAVEFUNCTION_TYPES: Dict[str, type] = {}


def register(type_name: str):
    def wrap(cls):
        WAVEFUNCTION_TYPES[type_name] = cls
        cls.type_name = type_name
        return cls
    return wrap
