"""Smoke test of the main path on an NVIDIA GPU, through the user's entry
points, at the full width of the flagship 6x6 model.

    python chip_smoke.py               # one GPU, phases 0-4
    python chip_smoke.py --four-cards  # four GPUs: only the sharded SR
                                       # epoch against one device

Phases (one JAX process; any failure exits non-zero before the last line):
  0  device: a GPU must be present; prints its name and power limit.
  1  deep48 artifact logψ on its 512 committed samples vs the CPU
     reference, at 'highest' and at the default (TF32) precision, and the
     reweighted E/N against QMC for both.
  2  `cgs train` of configs/square66_conv_sr.json for 3 epochs, then
     `cgs eval` and a resumed 4th epoch (checkpoint save and restore).
  3  the RBM exchange-sweep kernel against the full-recompute oracle at
     6x6, H=64, 2048 chains; sweeps/s of the kernel and of plain XLA;
     `cgs train` of a pure RBM on the sampler registry's kernel entry.
  4  `cgs train` of configs/j1j2_chain8_complex_sr.json for 2 epochs
     (complex64 amplitudes and complex SR).
Every number printed carries the card's name and power limit.  The last
line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = ''


def say(msg: str) -> None:
    print(f'{msg}  [{CARD}]', flush=True)


def check_device(count: int):
    global CARD
    import jax
    backend = jax.default_backend()
    if backend != 'gpu':
        raise SystemExit(f'chip_smoke needs an NVIDIA GPU; JAX backend is '
                         f'{backend!r}')
    if jax.device_count() < count:
        raise SystemExit(f'needs {count} GPUs, JAX sees {jax.device_count()}')
    query = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    CARD = query.splitlines()[0]
    print(f'[0] jax.devices() = {jax.devices()}')
    print(f'[0] device_kind = {jax.devices()[0].device_kind}')
    print(f'[0] nvidia-smi: {query}', flush=True)
    return jax.devices()[0]


def run_cli(argv):
    """cgs <argv> in-process; returns what it printed (also echoed)."""
    from cgs_vmc_jax import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise RuntimeError(f'cgs {" ".join(argv)} returned {rc}')
    return buf.getvalue()


def epoch_energies(run_dir):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    energies = [r['energy'] for r in records]
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f'non-finite epoch energy in {energies}')
    return records


def phase_flagship_forward():
    from cgs_vmc_jax import gpu_checks
    hi = gpu_checks.flagship_parity('highest')
    say(f'[1a] deep48 logψ vs CPU reference at highest precision: '
        f'max|Δlog| = {hi["max_dlogpsi"]:.3e} (tolerance '
        f'{gpu_checks.LOGPSI_TOL_HIGHEST:.0e}); reweighted E/N = '
        f'{hi["energy_per_site"]:.6f} (QMC {gpu_checks.E_QMC} +/- '
        f'{gpu_checks.ENERGY_BAND})')
    lo = gpu_checks.flagship_parity(None)
    say(f'[1b] deep48 logψ vs CPU reference at default (TF32) precision: '
        f'max|Δlog| = {lo["max_dlogpsi"]:.3e}; reweighted E/N = '
        f'{lo["energy_per_site"]:.6f} (QMC {gpu_checks.E_QMC} +/- '
        f'{gpu_checks.ENERGY_BAND})')


def phase_flagship_train(runs):
    run = os.path.join(runs, 'square66_conv_sr')
    config = os.path.join(ROOT, 'configs', 'square66_conv_sr.json')
    t0 = time.perf_counter()
    run_cli(['train', '--config', config, '--checkpoint_dir', run,
             '--override', 'num_epochs=3'])
    records = epoch_energies(run)
    assert len(records) == 3, records
    say(f'[2a] 3 flagship SR epochs (5x32 sym. conv, dense minSR, 4096 '
        f'samples): E = {[round(r["energy"], 6) for r in records]}, '
        f'epoch_time_s = {[r["epoch_time_s"] for r in records]}, '
        f'{time.perf_counter() - t0:.1f} s with compilation')
    out = run_cli(['eval', '--checkpoint_dir', run])
    line = next(l for l in out.splitlines() if l.startswith('Energy:'))
    mean = float(line.split()[1])
    assert math.isfinite(mean), line
    say(f'[2b] cgs eval of the 3-epoch checkpoint: {line}')
    run_cli(['train', '--checkpoint_dir', run, '--resume',
             '--override', 'num_epochs=4'])
    records = epoch_energies(run)
    assert [r['epoch'] for r in records] == [1, 2, 3, 4], records
    say(f'[2c] resumed from the epoch-3 checkpoint: epoch 4 E = '
        f'{records[-1]["energy"]:.6f}')


def sweeps_per_sec(fn, problem, num_sweeps=400, reps=3):
    import jax
    from cgs_vmc_jax.sampler import kernels
    w, b, a, configs = problem
    n_chains, n_sites = configs.shape
    picks = kernels.sample_picks(jax.random.key(5), num_sweeps * n_sites,
                                 n_sites, n_chains)
    out = fn(w, b, a, configs, picks, jax.random.key(6))
    jax.block_until_ready(out)
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        out = fn(w, b, a, out.configs, picks, jax.random.key(7 + rep))
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return num_sweeps / sorted(times)[len(times) // 2]


def phase_rbm(runs):
    from cgs_vmc_jax import gpu_checks
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.models import build_wavefunction
    from cgs_vmc_jax.sampler import kernels, registry
    for name, fn in (('Pallas-Triton kernel', kernels.rbm_sweeps),
                     ('plain XLA', kernels.rbm_sweeps_xla)):
        res = gpu_checks.rbm_kernel_parity(fn)
        say(f'[3a] RBM sweeps, {name} vs full-recompute oracle (36 sites, '
            f'H=64, 2048 chains, 2 sweeps, every matmul at HIGHEST '
            f'precision): configs and accept counts identical, max|Δlog| '
            f'= {res["max_dlogpsi"]:.3e}, acceptance = '
            f'{res["acceptance"]:.4f}')
    problem = gpu_checks.rbm_problem()
    for name, fn in (('Pallas-Triton kernel', kernels.rbm_sweeps),
                     ('plain XLA', kernels.rbm_sweeps_xla)):
        say(f'[3b] {name}: {sweeps_per_sec(fn, problem):.1f} sweeps/s '
            f'(36 sites, H=64, 2048 chains, 400 sweeps per call, median '
            f'of 3)')
    run = os.path.join(runs, 'chain20_rbm')
    run_cli(['train', '--checkpoint_dir', run, '--num_sites', '20',
             '--num_epochs', '3', '--wavefunction_type', 'rbm',
             '--optimizer_type', 'EnergyGradient', '--heisenberg_jx=-1.0',
             '--override', 'num_fc_layers=0,batch_size=512'])
    config = Config.load(os.path.join(run, 'config.json'))
    entry = registry.resolved_name(build_wavefunction(config), config)
    assert entry == 'rbm_pallas', entry
    records = epoch_energies(run)
    say(f'[3c] cgs train, pure RBM on a 20-site chain: sampler entry '
        f'{entry!r}, E = {[round(r["energy"], 6) for r in records]}, '
        f'acceptance = {records[-1]["acceptance_rate"]:.4f}')


def phase_complex(runs):
    run = os.path.join(runs, 'j1j2_complex')
    config = os.path.join(ROOT, 'configs', 'j1j2_chain8_complex_sr.json')
    run_cli(['train', '--config', config, '--checkpoint_dir', run,
             '--override', 'num_epochs=2'])
    records = epoch_energies(run)
    assert len(records) == 2, records
    say(f'[4] 2 complex SR epochs (J1-J2 chain, complex ansatz): E = '
        f'{[round(r["energy"], 6) for r in records]}')


def phase_four_cards():
    """One flagship-shaped SR epoch (sample_cg) sharded over 4 GPUs vs the
    same epoch on one GPU from the same initial state, both at full f32
    matmul precision."""
    import numpy as np
    import jax
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.optim import StochasticReconfiguration
    from cgs_vmc_jax.parallel import mesh as mesh_lib
    from cgs_vmc_jax.train import build_hamiltonian
    from cgs_vmc_jax.models import build_wavefunction

    config = Config.load(os.path.join(ROOT, 'configs',
                                      'square66_conv_sr.json'))
    # CG run to convergence: at the config's 100 iterations it stops with
    # a residual near |grad|, and two unconverged iterates that were
    # summed in another order differ by several per cent.
    config = config.replace(sr_solver='sample_cg', num_devices=4,
                            sr_cg_maxiter=1000)
    wf = build_wavefunction(config)
    opt = StochasticReconfiguration(wf, build_hamiltonian(config), config)
    state = opt.init_state(jax.random.key(config.seed))

    # Both sides at full f32 precision: with TF32 matmuls the CG solve
    # carries ~1e-3 relative noise per matvec, and GEMMs of other shapes
    # round differently, which would hide the sharding logic under it.
    with jax.default_matmul_precision('highest'):
        one_state, one_metrics = jax.jit(opt.epoch)(state)
        mesh = mesh_lib.make_mesh(4)
        _, metric_shapes = jax.eval_shape(opt.epoch, state)
        epoch4 = mesh_lib.sharded_epoch_fn(opt.epoch, mesh, state,
                                           list(metric_shapes))
        sharded = mesh_lib.shard_train_state(state, mesh)
        four_state, four_metrics = epoch4(sharded)
        jax.block_until_ready(four_state)

    for name, arr in (('input', sharded.sampler.configs),
                      ('output', four_state.sampler.configs)):
        devices = [s.device for s in arr.addressable_shards]
        rows = [s.data.shape[0] for s in arr.addressable_shards]
        assert len(set(devices)) == 4, (name, devices)
        assert rows == [config.batch_size // 4] * 4, (name, rows)
    say(f'[5a] sampler state sharded over {sorted(d.id for d in devices)}: '
        f'{rows} chains per device')

    e1 = float(one_metrics['energy'])
    e4 = float(four_metrics['energy'])
    p1 = np.concatenate([np.ravel(x) for x in
                         jax.tree.leaves(jax.device_get(one_state.params))])
    p4 = np.concatenate([np.ravel(x) for x in
                         jax.tree.leaves(jax.device_get(four_state.params))])
    p0 = np.concatenate([np.ravel(x) for x in
                         jax.tree.leaves(jax.device_get(state.params))])
    rel_e = abs(e4 - e1) / abs(e1)
    rel_update = (np.linalg.norm((p4 - p0) - (p1 - p0))
                  / np.linalg.norm(p1 - p0))
    # Same chains and per-chain keys on both sides, so the samples agree;
    # the moments are summed in another order (pmean over 4 partial sums),
    # and CG ends at a small residual in a different iterate, which the
    # diagonal shift 1e-2 amplifies at most ~100x.
    assert rel_e <= 1e-5, (e1, e4)
    assert rel_update <= 1e-3, rel_update
    say(f'[5b] SR epoch (5x32 sym. conv, sample_cg to convergence, 4096 '
        f'samples, highest precision): E on 4 GPUs {e4:.7f} vs 1 GPU '
        f'{e1:.7f} (rel {rel_e:.2e}, tolerance 1e-5); CG residual '
        f'{float(four_metrics["sr_residual_norm"]):.2e} vs '
        f'{float(one_metrics["sr_residual_norm"]):.2e}; parameter update '
        f'rel. difference {rel_update:.2e} (tolerance 1e-3)')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--four-cards', action='store_true',
                        help='run only the 4-GPU sharded SR comparison')
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1

    import jax
    from cgs_vmc_jax.utils import compile_cache
    compile_cache.configure()
    device = check_device(count)

    if args.four_cards:
        phase_four_cards()
    else:
        runs_root = os.path.join(ROOT, '.chip_smoke_runs')
        os.makedirs(runs_root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=runs_root) as runs:
            phase_flagship_forward()
            phase_flagship_train(runs)
            phase_rbm(runs)
            phase_complex(runs)

    print(json.dumps({'ok': True, 'device': {
        'platform': device.platform, 'kind': device.device_kind,
        'count': len(jax.devices())}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
