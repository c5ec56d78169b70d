"""epochs_per_call: k epochs per compiled dispatch (lax.scan fusion).

The scanned program must be observationally identical to k sequential
per-epoch dispatches: same per-epoch metrics stream, same epoch counter,
same physics trajectory (bitwise on CPU — the scan body IS the epoch
function), including a remainder block when k does not divide num_epochs.
"""

import json
import os

import numpy as np
import pytest

from cgs_vmc_jax.config import Config
from cgs_vmc_jax.train import train

N = 8


def _config(tmp_path, tag, **kwargs) -> Config:
    defaults = dict(
        checkpoint_dir=str(tmp_path / tag),
        num_sites=N,
        wavefunction_type='rbm', num_fc_layers=1, fc_layer_size=12,
        wavefunction_optimizer_type='EnergyGradient',
        batch_size=64, num_batches_per_epoch=2,
        num_equilibration_sweeps=2, num_monte_carlo_sweeps=1,
        num_epochs=7, checkpoint_frequency=3,
        learning_rates=[3e-3], learning_rate_stops=[],
        heisenberg_jx=-1.0, seed=5,
        use_fast_sampler=False,
    )
    defaults.update(kwargs)
    return Config(**defaults)


def _metric_rows(run_dir):
    path = os.path.join(run_dir, 'metrics.jsonl')
    return [json.loads(line) for line in open(path)]


@pytest.mark.slow
def test_scanned_epochs_match_per_epoch_dispatch(tmp_path):
    cfg1 = _config(tmp_path, 'per_epoch', epochs_per_call=1)
    cfgk = _config(tmp_path, 'scanned', epochs_per_call=3)  # 3+3+1 remainder

    state1 = train(cfg1)
    statek = train(cfgk)

    rows1 = _metric_rows(cfg1.checkpoint_dir)
    rowsk = _metric_rows(cfgk.checkpoint_dir)
    assert len(rows1) == len(rowsk) == cfg1.num_epochs
    assert [r['epoch'] for r in rowsk] == [r['epoch'] for r in rows1]
    # Same RNG threading => the same sampled trajectory; energies agree
    # to float tolerance (scan fusion may reassociate reductions).
    e1 = np.array([r['energy'] for r in rows1])
    ek = np.array([r['energy'] for r in rowsk])
    np.testing.assert_allclose(ek, e1, rtol=1e-4, atol=1e-4)

    assert int(statek.epoch) == cfg1.num_epochs
    leaves1 = [np.asarray(x) for x in
               __import__('jax').tree.leaves(state1.params)]
    leavesk = [np.asarray(x) for x in
               __import__('jax').tree.leaves(statek.params)]
    for a, b in zip(leaves1, leavesk):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_scanned_epochs_on_mesh(tmp_path):
    # The scan wrapper must compose with the shard_map epoch (metrics
    # gain a leading [k] axis inside the replicated out_specs).
    cfg = _config(tmp_path, 'mesh', epochs_per_call=2, num_epochs=4,
                  num_devices=8, batch_size=16 * 8)
    train(cfg)
    rows = _metric_rows(cfg.checkpoint_dir)
    assert len(rows) == 4
    assert [r['epoch'] for r in rows] == [1, 2, 3, 4]
    energies = [r['energy'] for r in rows]
    assert np.all(np.isfinite(energies))
    assert all(0 < r['acceptance_rate'] <= 1 for r in rows)


@pytest.mark.slow
def test_scanned_epochs_checkpoint_and_resume(tmp_path):
    cfg = _config(tmp_path, 'ck', epochs_per_call=2, num_epochs=6,
                  checkpoint_frequency=2)
    train(cfg)
    # Resume extends the run from the saved counter with the scan in place.
    cfg2 = cfg.replace(num_epochs=8)
    state = train(cfg2, resume=True)
    assert int(state.epoch) == 8
    assert len(_metric_rows(cfg.checkpoint_dir)) >= 8


@pytest.mark.slow
def test_scanned_epochs_compose_with_param_ema(tmp_path):
    """EMA wrapped INSIDE the scan: k fused epochs update the average k
    times, identically to per-epoch dispatch."""
    import jax
    cfg1 = _config(tmp_path, 'ema1', epochs_per_call=1, param_ema_decay=0.9)
    cfgk = _config(tmp_path, 'emak', epochs_per_call=3, param_ema_decay=0.9)
    state1 = train(cfg1)
    statek = train(cfgk)
    e1 = [np.asarray(x) for x in jax.tree.leaves(state1.extra['ema_params'])]
    ek = [np.asarray(x) for x in jax.tree.leaves(statek.extra['ema_params'])]
    for a, b in zip(e1, ek):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_param_ema_on_mesh(tmp_path):
    """The EMA wrapper composes with the shard_map epoch: the slot rides
    extra (replicated), updates every epoch, and matches the
    single-device EMA for the same total chains."""
    import jax
    cfg1 = _config(tmp_path, 'ema_1dev', num_epochs=3, param_ema_decay=0.7,
                   batch_size=16 * 8)
    cfg8 = _config(tmp_path, 'ema_8dev', num_epochs=3, param_ema_decay=0.7,
                   num_devices=8, batch_size=16 * 8)
    s1 = train(cfg1)
    s8 = train(cfg8)
    e1 = np.concatenate([np.asarray(x).ravel() for x in
                         jax.tree.leaves(s1.extra['ema_params'])])
    e8 = np.concatenate([np.asarray(x).ravel() for x in
                         jax.tree.leaves(s8.extra['ema_params'])])
    assert np.all(np.isfinite(e8))
    np.testing.assert_allclose(e8, e1, rtol=2e-4, atol=2e-5)
