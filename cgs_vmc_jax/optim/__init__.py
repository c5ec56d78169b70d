"""Optimizer registries (reference cgs_vmc/training.py:913-925, plus the
new SR optimizer required by the rebuild spec)."""

from cgs_vmc_jax.optim.common import SgdOptimizer, TrainState, make_optax_optimizer
from cgs_vmc_jax.optim.energy_gradient import EnergyGradientOptimizer
from cgs_vmc_jax.optim.excited import (
    PenaltyExcitedOptimizer,
    SRPenaltyExcitedOptimizer,
)
from cgs_vmc_jax.optim.sr import StochasticReconfiguration
from cgs_vmc_jax.optim.swo import (
    BasisIterationSWO,
    DualSamplingSWO,
    ImaginaryTimeSWO,
    LogOverlapImaginaryTimeSWO,
    LogOverlapSWO,
    SupervisedWavefunctionOptimizer,
)

GROUND_STATE_OPTIMIZERS = {
    'EnergyGradient': EnergyGradientOptimizer,
    'LogOverlapITSWO': LogOverlapImaginaryTimeSWO,
    'ITSWO': ImaginaryTimeSWO,
    'SR': StochasticReconfiguration,
    'ExcitedPenalty': PenaltyExcitedOptimizer,
    'ExcitedSR': SRPenaltyExcitedOptimizer,
}

SUPERVISED_OPTIMIZERS = {
    'SWO': SupervisedWavefunctionOptimizer,
    'LogOverlapSWO': LogOverlapSWO,
    'DualSamplingSWO': DualSamplingSWO,
    'BasisIterSWO': BasisIterationSWO,
}

__all__ = [
    'TrainState', 'SgdOptimizer', 'make_optax_optimizer',
    'EnergyGradientOptimizer', 'StochasticReconfiguration',
    'PenaltyExcitedOptimizer', 'SRPenaltyExcitedOptimizer',
    'ImaginaryTimeSWO', 'LogOverlapImaginaryTimeSWO',
    'SupervisedWavefunctionOptimizer', 'LogOverlapSWO', 'DualSamplingSWO',
    'BasisIterationSWO',
    'GROUND_STATE_OPTIMIZERS', 'SUPERVISED_OPTIMIZERS',
]
