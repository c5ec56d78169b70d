"""cgs-vmc-jax: neural-quantum-state VMC framework in JAX.

Built from scratch in JAX/XLA (a Pallas GPU kernel on the RBM sampler)
with the capabilities of ClarkResearchGroup/cgs-vmc; see SURVEY.md for the structural map and
PARITY.md for the component-by-component correspondence.

Lazy top-level conveniences (importing the package does not pull in jax):

    from cgs_vmc_jax import Config, build_wavefunction, train
"""

__version__ = '0.1.0'

_LAZY = {
    'Config': ('cgs_vmc_jax.config', 'Config'),
    'build_wavefunction': ('cgs_vmc_jax.models', 'build_wavefunction'),
    'train': ('cgs_vmc_jax.train', 'train'),
    'distill': ('cgs_vmc_jax.train', 'distill'),
    'evaluate_operator': ('cgs_vmc_jax.evaluate', 'evaluate_operator'),
    'evaluate_vector': ('cgs_vmc_jax.evaluate', 'evaluate_vector'),
    'HeisenbergHamiltonian': ('cgs_vmc_jax.ops.heisenberg',
                              'HeisenbergHamiltonian'),
    'TransverseFieldIsingHamiltonian': ('cgs_vmc_jax.ops.ising',
                                        'TransverseFieldIsingHamiltonian'),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['__version__'] + sorted(_LAZY)
