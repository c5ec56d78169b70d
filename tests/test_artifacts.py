"""Shipped artifacts must load, evaluate, and still carry their claimed
physics (round-2 review: finiteness-only checks would pass a corrupted or
regressed artifact).

The energy oracle exploits the zero-variance principle: for an ansatz
that approximates an eigenstate, the local energy E_loc(R) =
<R|H|psi>/<R|psi> is close to E_0 for EVERY configuration R — including
seeded RANDOM ones — so one fused local-energy batch (no MC loop, no
equilibration) regression-tests the weights in seconds on CPU.  The
recorded fingerprint means were measured at commit time with these exact
seeds; a corrupted artifact scatters E_loc wildly (mean and std blow up),
a regressed one drifts outside the band.
"""

import os

import numpy as np
import jax
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.utils import codec

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), '..', 'artifacts')

_COMMON_6 = dict(num_sites=36, size_x=6, size_y=6,
                 wavefunction_type='conv_2d', kernel_size=3,
                 symmetrize=True, heisenberg_jx=-1.0)
_COMMON_10 = dict(num_sites=100, size_x=10, size_y=10,
                  wavefunction_type='conv_2d', kernel_size=3,
                  symmetrize=True, heisenberg_jx=-1.0)

# (artifact, config, (size_x, size_y), n_configs,
#  fingerprint mean E/N over the seeded random batch, band)
# Bands: ~3-4 sigma of the seeded batch mean; the fingerprint is
# deterministic given the seeds, so drift beyond the band means the
# committed weights changed (or regressed) without this table updating.
CASES = [
    ('heisenberg_6x6_deep48',
     Config(num_conv_layers=7, num_conv_filters=48, **_COMMON_6),
     (6, 6), 12, -0.678510, 0.004),
    ('heisenberg_6x6_symconv48_v2',
     Config(num_conv_layers=5, num_conv_filters=48, **_COMMON_6),
     (6, 6), 12, -0.681685, 0.004),
    ('heisenberg_6x6_symconv_v2',
     Config(num_conv_layers=5, num_conv_filters=32, **_COMMON_6),
     (6, 6), 12, -0.679797, 0.004),
    ('heisenberg_10x10_symconv_v3',
     Config(num_conv_layers=5, num_conv_filters=32, **_COMMON_10),
     (10, 10), 8, -0.655397, 0.008),
    ('heisenberg_10x10_deep32_cont',
     Config(num_conv_layers=7, num_conv_filters=32, **_COMMON_10),
     (10, 10), 8, -0.660801, 0.008),
    ('heisenberg_12x12_symconv',
     Config(num_sites=144, size_x=12, size_y=12,
            wavefunction_type='conv_2d', kernel_size=3, symmetrize=True,
            heisenberg_jx=-1.0, num_conv_layers=5, num_conv_filters=32),
     (12, 12), 6, -0.663586, 0.010),
    # The two 12x12 7x32 headline artifacts (RESULTS rows ++deep and
    # ++anneal: rel_err 5.15e-4 at epoch 1400; 4.98e-4 after the
    # +300-epoch anneal — the <5e-4 target met at training time).
    ('heisenberg_12x12_deep32',
     Config(num_sites=144, size_x=12, size_y=12,
            wavefunction_type='conv_2d', kernel_size=3, symmetrize=True,
            heisenberg_jx=-1.0, num_conv_layers=7, num_conv_filters=32),
     (12, 12), 6, -0.668395, 0.010),
    ('heisenberg_12x12_deep32_anneal',
     Config(num_sites=144, size_x=12, size_y=12,
            wavefunction_type='conv_2d', kernel_size=3, symmetrize=True,
            heisenberg_jx=-1.0, num_conv_layers=7, num_conv_filters=32),
     (12, 12), 6, -0.668431, 0.010),
]


def _local_energies(name, config, size, n_configs):
    n = config.num_sites
    wf = build_wavefunction(config)
    path = os.path.join(ARTIFACT_DIR, f'{name}.msgpack')
    params = codec.from_bytes(wf.init(jax.random.key(0)),
                              open(path, 'rb').read())
    ham = HeisenbergHamiltonian(
        lattice.square_lattice_bonds(*size), -1.0, 1.0)
    configs = basis.random_configurations(jax.random.key(1234), n, n_configs)
    return np.asarray(ham.local_value(wf, params, configs)) / n


@pytest.mark.slow
@pytest.mark.parametrize('name,config,size,n_configs,expected,band',
                         CASES, ids=[c[0] for c in CASES])
def test_artifact_energy_fingerprint(name, config, size, n_configs,
                                     expected, band):
    el = _local_energies(name, config, size, n_configs)
    assert np.isfinite(el).all()
    mean, std = el.mean(), el.std()
    assert abs(mean - expected) < band, (
        f'{name}: seeded local-energy mean {mean:.6f} drifted from the '
        f'recorded fingerprint {expected:.6f} (band {band}) — the '
        f'committed weights changed or regressed')
    # Corruption check: near an eigenstate the local energy has small
    # variance even over random configs; shuffled/damaged weights
    # scatter it by O(1).
    assert std < 0.06, f'{name}: local-energy std {std:.4f} blown up'


@pytest.mark.slow
def test_10x10_deep_artifact_physical_band():
    """The deep 10x10 artifact is retrained across rounds (its weights
    legitimately move), so it gets a physical band around the QMC value
    rather than a frozen fingerprint."""
    config = Config(num_conv_layers=7, num_conv_filters=32, **_COMMON_10)
    el = _local_energies('heisenberg_10x10_deep32_cont', config,
                         (10, 10), 8)
    assert np.isfinite(el).all()
    assert abs(el.mean() - (-0.671549)) < 0.03
    assert el.std() < 0.08
