"""Complex-phase wavefunctions: psi = sign_m * exp(log|psi| + i*phi).

NEW capability beyond the reference (its ansatzes are strictly real,
cgs_vmc/wavefunctions.py:328-1154; its evaluator merely *formats* a zero
imaginary part, cgs_vmc/evaluation.py:223): a trainable phase network
lets VMC represent sign/phase structures that no positive ansatz can —
frustrated models (J1-J2), where the Marshall gauge does not exist.

Representation: the modulus network contributes (sign, log|psi|) exactly
as any real ansatz; the phase network's raw output (its ``.log`` under
'exp' activation) becomes the phase phi, carried in the imaginary part
of ``LogAmp.log``.  Everything downstream (Metropolis via ``log.real``,
batched local energy via complex ``exp``, energy gradient / SR via
split-real pullbacks) handles the complex log natively — see
sampler/metropolis.py, ops/heisenberg.py, optim/{energy_gradient,sr}.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.logamp import LogAmp


class ComplexPhaseWavefunction(Wavefunction):
    """Pairs a modulus ansatz with a phase ansatz.

    The phase network is built with output_activation='exp' so its
    ``apply(...).log`` is the raw network output, used directly as phi
    (radians, unconstrained — exp(i*phi) is automatically periodic).
    """

    def __init__(self, modulus_wf: Wavefunction, phase_wf: Wavefunction,
                 name: str = 'complex_phase'):
        self.name = name
        self._modulus = modulus_wf
        self._phase = phase_wf

    def init(self, key: jax.Array) -> Params:
        key_m, key_p = jax.random.split(key)
        return {'modulus': self._modulus.init(key_m),
                'phase': self._phase.init(key_p)}

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        mod = self._modulus.apply(params['modulus'], configs)
        phi = self._phase.apply(params['phase'], configs).log
        return LogAmp(mod.sign, mod.log + 1j * phi.astype(mod.log.dtype))


def build_complex_wavefunction(config) -> ComplexPhaseWavefunction:
    """Factory for composite type 'complex':
    composite_wavefunction_types = (modulus_type, phase_type);
    composite_output_activations[0] applies to the modulus part, the phase
    part is forced to 'exp' (raw log output = phase)."""
    from cgs_vmc_jax.models.base import WAVEFUNCTION_TYPES

    type_m, type_p = config.composite_wavefunction_types
    act_m = config.composite_output_activations[0] or 'exp'
    config_m = dataclasses.replace(
        config, wavefunction_type=type_m, output_activation=act_m)
    config_p = dataclasses.replace(
        config, wavefunction_type=type_p, output_activation='exp')
    modulus = WAVEFUNCTION_TYPES[type_m].from_config(config_m, name='modulus')
    phase = WAVEFUNCTION_TYPES[type_p].from_config(config_p, name='phase')
    return ComplexPhaseWavefunction(modulus, phase)


def is_complex(wf: Wavefunction, params: Params, n_sites: int) -> bool:
    """Trace-time (shape-only) check whether the ansatz emits complex logs."""
    dummy = jnp.ones((1, n_sites), jnp.float32)
    out = jax.eval_shape(wf.apply, params, dummy)
    return jnp.issubdtype(out.log.dtype, jnp.complexfloating)
