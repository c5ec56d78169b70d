"""Exact-vector ansatz: a trainable dense state vector in a fixed Sz sector.

Log-domain re-design of the reference FullVector
(cgs_vmc/wavefunctions.py:1001-1080): configurations are mapped to dense
sector indices via Lin tables (Lin, H.Q. 1990) and the amplitude is a gather
from a trainable vector.  Used as an exact target/supervisor for SWO and as
a zero-variance oracle in tests (seeded with the ED ground state it must
give E = E0 with zero variance).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax import basis as basis_lib
from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops.logamp import LogAmp


@register('ed_vector')
class FullVector(Wavefunction):

    def __init__(self, num_sites: int,
                 top_lin_table: np.ndarray,
                 bot_lin_table: np.ndarray,
                 initial_vector: np.ndarray,
                 name: str = 'full_vector'):
        self.name = name
        self.num_sites = num_sites
        # Host numpy lookup tables, lowered as constants (models/symmetry.py).
        self.top_lin_table = np.asarray(top_lin_table, np.int32)
        self.bot_lin_table = np.asarray(bot_lin_table, np.int32)
        self.initial_vector = np.asarray(initial_vector, np.float32)

    @classmethod
    def for_sector(cls, num_sites: int, initial_vector: np.ndarray,
                   n_up: int | None = None, name: str = 'full_vector'
                   ) -> 'FullVector':
        """Builds Lin tables in-process (no table files needed).

        `initial_vector` is given in `basis.enumerate_sz_basis` order (the
        order the ED oracle and evaluators use) and is permuted into the
        Lin-table's dense-index order internally.
        """
        import jax.numpy as jnp_local
        top, bot = basis_lib.make_lin_tables(num_sites, n_up)
        n_down = None if n_up is None else num_sites - n_up
        states = basis_lib.enumerate_sz_basis(num_sites, n_down)
        lin_idx = np.asarray(basis_lib.lin_index(
            jnp_local.asarray(states), jnp_local.asarray(top),
            jnp_local.asarray(bot)))
        vector = np.asarray(initial_vector, np.float32)
        if vector.shape[0] != states.shape[0]:
            raise ValueError(
                f'vector length {vector.shape[0]} != sector dimension '
                f'{states.shape[0]}')
        permuted = np.empty_like(vector)
        permuted[lin_idx] = vector
        return cls(num_sites, top, bot, permuted, name=name)

    def init(self, key: jax.Array) -> Params:
        del key
        return {'ed_vector': jnp.asarray(self.initial_vector)}

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        idx = basis_lib.lin_index(configs, self.top_lin_table,
                                  self.bot_lin_table)
        value = params['ed_vector'][idx]
        return LogAmp(jnp.sign(value), jnp.log(jnp.abs(value)))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'FullVector':
        """Loads Lin tables + initial vector from files (reference format:
        cgs_vmc/wavefunctions.py:1057-1080, np.genfromtxt text files in the
        checkpoint dir).  Falls back to in-process table construction when
        table files are unset."""
        import os
        dir_path = config.checkpoint_dir
        vec_path = os.path.join(dir_path, config.ed_vector_file)
        initial_vector = np.genfromtxt(vec_path, dtype=np.float32)
        kwargs = {}
        if name:
            kwargs['name'] = name
        if config.top_lin_table_file and config.bot_lin_table_file:
            top = np.genfromtxt(
                os.path.join(dir_path, config.top_lin_table_file),
                dtype=np.int64)
            bot = np.genfromtxt(
                os.path.join(dir_path, config.bot_lin_table_file),
                dtype=np.int64)
            return cls(config.num_sites, top, bot, initial_vector, **kwargs)
        return cls.for_sector(config.num_sites, initial_vector, **kwargs)
