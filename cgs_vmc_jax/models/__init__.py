"""Wavefunction ansatz registry and factory.

Mirrors the reference's `build_wavefunction` dispatch + composite handling
(cgs_vmc/wavefunctions.py:1157-1211): registered single types, or
'sum'/'diff'/'prod' composites of two sub-ansatzes with per-part output
activations combined via log-domain wavefunction algebra.
"""

from __future__ import annotations

import dataclasses

from cgs_vmc_jax.models.base import (
    Params,
    ProductOfWavefunctions,
    ScaledWavefunction,
    SumOfWavefunctions,
    TransformedWavefunction,
    Wavefunction,
    WAVEFUNCTION_TYPES,
    register,
)

# Importing the ansatz modules populates WAVEFUNCTION_TYPES.
from cgs_vmc_jax.models.feedforward import (
    FullyConnectedNetwork,
    RestrictedBoltzmannNetwork,
)
from cgs_vmc_jax.models.conv import (
    Conv1DNetwork,
    Conv2DNetwork,
    ResNet1D,
    ResNet2D,
)
from cgs_vmc_jax.models.mps import MatrixProductState
from cgs_vmc_jax.models.determinant import FullyConnectedNNB, ProjectedBDG
from cgs_vmc_jax.models.full_vector import FullVector
from cgs_vmc_jax.models.graph_conv import GraphConvNetwork
from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_jax.models.jastrow import JastrowWavefunction
from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_jax.models.pixelcnn import MaskedConv2DAutoregressive
from cgs_vmc_jax.models.attention import SpinTransformer


COMPOSITE_TYPES = ('sum', 'diff', 'prod', 'complex')


def build_wavefunction(config) -> Wavefunction:
    """Builds the ansatz requested by ``config.wavefunction_type``.

    Raises:
      ValueError: the requested type is not registered.
    """
    from cgs_vmc_jax.models.symmetry import maybe_symmetrize

    wf_type = config.wavefunction_type
    if wf_type in WAVEFUNCTION_TYPES:
        return maybe_symmetrize(
            WAVEFUNCTION_TYPES[wf_type].from_config(config), config)

    if wf_type == 'complex':
        from cgs_vmc_jax.models.complex_phase import build_complex_wavefunction
        return maybe_symmetrize(build_complex_wavefunction(config), config)

    if wf_type in COMPOSITE_TYPES:
        type_a, type_b = config.composite_wavefunction_types
        # Unset activations default to 'exp' (raw log output), matching
        # build_complex_wavefunction, instead of a KeyError at apply time.
        act_a, act_b = (a or 'exp' for a in config.composite_output_activations)
        config_a = dataclasses.replace(
            config, wavefunction_type=type_a, output_activation=act_a)
        config_b = dataclasses.replace(
            config, wavefunction_type=type_b, output_activation=act_b)
        wf_a = WAVEFUNCTION_TYPES[type_a].from_config(config_a, name='wf_a')
        wf_b = WAVEFUNCTION_TYPES[type_b].from_config(config_b, name='wf_b')
        if wf_type == 'sum':
            composite = wf_a + wf_b
        elif wf_type == 'diff':
            composite = wf_a - wf_b
        else:
            composite = wf_a * wf_b
        return maybe_symmetrize(composite, config)

    raise ValueError(
        f'Provided wavefunction_type is not registered: {wf_type!r}. '
        f'Known: {sorted(WAVEFUNCTION_TYPES)} + {COMPOSITE_TYPES}')


__all__ = [
    'Params', 'Wavefunction', 'WAVEFUNCTION_TYPES', 'register',
    'SumOfWavefunctions', 'ProductOfWavefunctions', 'ScaledWavefunction',
    'TransformedWavefunction', 'build_wavefunction',
    'FullyConnectedNetwork', 'RestrictedBoltzmannNetwork',
    'Conv1DNetwork', 'Conv2DNetwork', 'ResNet1D', 'ResNet2D',
    'MatrixProductState', 'ProjectedBDG', 'FullyConnectedNNB',
    'FullVector', 'GraphConvNetwork', 'ComplexPhaseWavefunction',
    'JastrowWavefunction', 'AutoregressiveSpinModel',
    'MaskedConv2DAutoregressive', 'SpinTransformer',
]
