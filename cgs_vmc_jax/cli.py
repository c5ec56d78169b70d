"""Command-line interface: ``cgs train | distill | eval | dump``.

Replaces the reference's three absl binaries (cgs_vmc/run_training.py,
run_supervised_training.py, run_energy_evaluation.py) with one entry point.
Config handling mirrors the reference flags: a JSON config persisted in the
checkpoint dir, CLI shortcuts for the common fields, and an ``--override``
comma-string for everything else (cgs_vmc/run_training.py:60-64).
"""

from __future__ import annotations

import argparse
import os
import sys

from cgs_vmc_jax.config import Config


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--checkpoint_dir', default='',
                        help='Run directory for checkpoints/metrics/config.')
    parser.add_argument('--config', default='',
                        help='Path to a config.json to start from.')
    parser.add_argument('--override', default='',
                        help='Comma-separated name=value config overrides '
                             '(lists as [a;b;c]).')
    parser.add_argument('--num_sites', type=int, default=None)
    parser.add_argument('--num_epochs', type=int, default=None)
    parser.add_argument('--wavefunction_type', default=None)
    parser.add_argument('--optimizer_type', default=None,
                        help='Ground-state or supervised optimizer name.')
    parser.add_argument('--heisenberg_jx', type=float, default=None)
    parser.add_argument('--seed', type=int, default=None)


def _build_config(args: argparse.Namespace, default_optimizer: str,
                  base: Config | None = None) -> Config:
    if base is not None:
        config = base
    else:
        config = Config.load(args.config) if args.config else Config()
    updates = {}
    if args.checkpoint_dir:
        updates['checkpoint_dir'] = args.checkpoint_dir
    for field in ('num_sites', 'num_epochs', 'wavefunction_type',
                  'heisenberg_jx', 'seed'):
        value = getattr(args, field)
        if value is not None:
            updates[field] = value
    if args.optimizer_type is not None:
        updates['wavefunction_optimizer_type'] = args.optimizer_type
    config = config.override_from_dict(updates)
    if not config.wavefunction_optimizer_type:
        config = config.replace(
            wavefunction_optimizer_type=default_optimizer)
    if args.override:
        config = config.parse(args.override)
    return config


def _resume_base(args: argparse.Namespace) -> Config | None:
    """--resume without --config: reload the run's persisted config.json
    (the reference likewise reread hparams.pbtxt from the run directory,
    cgs_vmc/run_energy_evaluation.py:45-47)."""
    if not (getattr(args, 'resume', False)
            and not args.config and args.checkpoint_dir):
        return None
    path = os.path.join(args.checkpoint_dir, 'config.json')
    return Config.load(path) if os.path.exists(path) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='cgs',
        description='Neural-quantum-state VMC framework in JAX.')
    sub = parser.add_subparsers(dest='command', required=True)

    p_train = sub.add_parser('train', help='Ground-state optimization.')
    _add_common(p_train)
    p_train.add_argument('--resume', action='store_true',
                         help='Resume from the latest checkpoint.')
    p_train.add_argument('--generate_vectors', action='store_true',
                         help='Dump full-basis amplitudes after training '
                              '(reference run_training.py:53-58).')
    p_train.add_argument('--basis_file_path', default='',
                         help='Basis file for --generate_vectors (defaults '
                              'to enumerating the Sz=0 sector).')
    p_train.add_argument('--orthogonal_to', action='append', default=[],
                         help='Frozen lower state (run dir or .msgpack '
                              'params artifact) for the ExcitedPenalty '
                              'optimizer; repeatable.')

    p_distill = sub.add_parser(
        'distill', help='Supervised distillation toward a trained target.')
    _add_common(p_distill)
    p_distill.add_argument('--supervisor_dir', required=True,
                           help='Checkpoint dir of the trained supervisor.')
    p_distill.add_argument('--resume', action='store_true')

    p_eval = sub.add_parser('eval', help='Monte Carlo observable evaluation.')
    _add_common(p_eval)
    p_eval.add_argument(
        '--params', default='',
        help='Evaluate a standalone params-only .msgpack artifact (e.g. '
             'artifacts/heisenberg_6x6_deep48.msgpack) instead of the run '
             "directory's latest checkpoint. Requires --config (or "
             '--checkpoint_dir with a config.json) describing the ansatz.')
    p_eval.add_argument(
        '--ema', action='store_true',
        help='Evaluate the Polyak/EMA-averaged weights '
             "(TrainState.extra['ema_params']) instead of the raw params; "
             'requires the run to have trained with param_ema_decay > 0.')
    p_eval.add_argument(
        '--observable', default='energy',
        help="What to measure: 'energy' (default), 'szsz:<dx>[;<dy>]' "
             "(longitudinal spin-spin correlation at lattice displacement "
             "(dx,dy); dy required iff BOTH size_x > 1 and size_y > 1 — "
             "a 1xN geometry is treated as a chain), "
             "'transverse:<dx>[;<dy>]' (SxSx+SySy, off-diagonal), "
             "'staggered_m2' (squared staggered magnetization), "
             "'total_spin2' (SU(2) Casimir <S_tot^2>; 0 for a singlet — "
             "Marshall-gauge-corrected automatically when the run "
             "trained with jx < 0), "
             "'sq:<qx>[;<qy>]' (longitudinal structure factor S(q), "
             "momentum in units of pi; qy required iff the lattice is "
             "2-D), or "
             "'renyi2:<i>-<j>' (Renyi-2 entanglement entropy of sites "
             'i..j via the two-replica swap estimator), or '
             "'lanczos' (single Lanczos-step energy E(alpha*) of "
             '(1+aH)|psi> plus zero-variance extrapolation — a '
             'measurement-time variational improvement, ops/lanczos.py).')

    p_dump = sub.add_parser(
        'dump', help='Write full-basis wavefunction amplitudes to a file.')
    _add_common(p_dump)
    p_dump.add_argument('--params', default='',
                        help='Params-only .msgpack artifact to dump.')

    p_evolve = sub.add_parser(
        'evolve', help='t-VMC time evolution from a trained checkpoint.')
    _add_common(p_evolve)
    p_evolve.add_argument('--params', default='',
                          help='Params-only .msgpack artifact to evolve.')
    p_evolve.add_argument('--dt', type=float, default=0.005,
                          help='Integrator time step.')
    p_evolve.add_argument('--steps', type=int, default=100,
                          help='Number of dt steps.')
    p_evolve.add_argument('--mode', choices=('real', 'imag'), default='real',
                          help="'real' = unitary dynamics (complex ansatz); "
                               "'imag' = normalized imaginary-time flow.")
    p_evolve.add_argument('--integrator', choices=('euler', 'heun'),
                          default='heun')
    p_evolve.add_argument(
        '--linear_response', default='',
        help='Momentum (units of pi) of a FourierSz probe, e.g. "1" on a '
             'chain or "1;1" on a 2-D lattice: runs the antithetic '
             'linear-response protocol (quench e^{±eps O_q}, evolve, '
             'C(t) = symmetric difference / 4 eps) instead of a plain '
             'evolution, and writes (t, C(t)) plus the spectral function '
             'S(q, omega) to linear_response.jsonl (ops/dynamics.py).')
    p_evolve.add_argument('--eps', type=float, default=0.05,
                          help='Quench strength for --linear_response.')

    args = parser.parse_args(argv)
    from cgs_vmc_jax.utils import compile_cache
    compile_cache.configure()

    if args.command == 'train':
        from cgs_vmc_jax.train import train
        config = _build_config(args, default_optimizer='ITSWO',
                               base=_resume_base(args))
        if args.basis_file_path:
            config = config.replace(basis_file_path=args.basis_file_path)
        if args.orthogonal_to:
            config = config.replace(orthogonal_to=list(args.orthogonal_to))
        state = train(config, resume=args.resume)
        if args.generate_vectors:
            from cgs_vmc_jax import models
            from cgs_vmc_jax.evaluate import evaluate_vector
            wf = models.build_wavefunction(config)
            evaluate_vector(wf, state.params, config,
                            epoch_num=config.num_epochs)
        return 0

    if args.command == 'distill':
        from cgs_vmc_jax.train import distill
        config = _build_config(args, default_optimizer='SWO',
                               base=_resume_base(args))
        config = config.replace(supervisor_dir=args.supervisor_dir)
        distill(config, resume=args.resume)
        return 0

    if args.command in ('eval', 'dump', 'evolve'):
        import jax
        from cgs_vmc_jax import models
        from cgs_vmc_jax.train import build_hamiltonian
        from cgs_vmc_jax.utils import checkpoint as ckpt_lib

        # Reload the run's persisted config (reference
        # run_energy_evaluation.py:45-47 reread hparams.pbtxt).
        run_dir = args.checkpoint_dir
        config_path = args.config or os.path.join(run_dir, 'config.json')
        loaded = Config.load(config_path)
        config = _build_config(
            args,
            default_optimizer=(loaded.wavefunction_optimizer_type or 'ITSWO'),
            base=loaded)
        config = config.replace(checkpoint_dir=run_dir)

        # Params-only restore: evaluation needs the WAVEFUNCTION, not the
        # training run — so (like the reference evaluator, which restored
        # trainables only, run_energy_evaluation.py:76-83) we never rebuild
        # the optimizer's TrainState.  This makes eval/dump/evolve work on
        # any run directory (ground-state, distilled/supervised) and on
        # standalone --params artifacts.
        wf = models.build_wavefunction(config)
        params_template = wf.init(jax.random.key(config.seed))
        params_path = getattr(args, 'params', '')
        if params_path:
            if getattr(args, 'ema', False):
                print('--ema cannot be combined with --params: standalone '
                      'artifacts are params-only and carry no EMA slot',
                      file=sys.stderr)
                return 1
            params = ckpt_lib.restore_params_only(params_path,
                                                  params_template)
        else:
            latest = ckpt_lib.latest_checkpoint(run_dir)
            if latest is None:
                print(f'No checkpoint found in {run_dir!r}', file=sys.stderr)
                return 1
            if getattr(args, 'ema', False):
                params = ckpt_lib.restore_ema_from_checkpoint(
                    latest, params_template)
            else:
                params = ckpt_lib.restore_params_from_checkpoint(
                    latest, params_template)
        hamiltonian = build_hamiltonian(config)

        if args.command == 'eval':
            from cgs_vmc_jax.evaluate import evaluate_operator
            observable = getattr(args, 'observable', 'energy')
            if observable.startswith('renyi2:'):
                from cgs_vmc_jax.ops.renyi import evaluate_renyi2
                lo, hi = (int(v) for v in
                          observable.split(':', 1)[1].split('-'))
                region = list(range(lo, hi + 1))
                s2, err = evaluate_renyi2(wf, params, region, config)
                print(f'Renyi-2 S2(sites {lo}..{hi}): {s2} +/- {err}')
                return 0
            if observable == 'lanczos':
                from cgs_vmc_jax.ops.lanczos import evaluate_lanczos
                res = evaluate_lanczos(
                    wf, params, hamiltonian, config,
                    sample_chunk=config.energy_chunk_samples,
                    energy_shift='auto')
                print(f'Energy <H>: {res.e0} +/- {res.e0_err}')
                print(f'Lanczos step alpha* (of 1 + aH): '
                      f'{res.alpha_physical}  [shifted-basis '
                      f'a\'={res.alpha}, shift={res.shift}]')
                print(f'Lanczos energy E(alpha*): {res.energy} +/- '
                      f'{res.energy_err}')
                print(f'Variance: {res.variance0} -> {res.variance_alpha}')
                print(f'Zero-variance extrapolation: {res.extrapolated}')
                print(f'Acceptance rate: {res.acceptance_rate:.4f}')
                return 0
            if observable == 'energy':
                operator, label = hamiltonian, 'Energy'
            elif observable.startswith(('szsz:', 'transverse:')):
                from cgs_vmc_jax import lattice as lattice_lib
                kind, spec = observable.split(':', 1)
                parts = [int(v) for v in spec.split(';')]
                # Must match lattice.displacement_pairs' own 2-D condition
                # (a 1xN geometry is a chain there).
                is_2d = (config.size_x > 1 and config.size_y > 1
                         and config.size_x * config.size_y
                         == config.num_sites)
                if is_2d and len(parts) != 2:
                    print(f'{kind}: a {config.size_x}x{config.size_y} '
                          'lattice needs a displacement VECTOR dx;dy '
                          f'(got {spec!r})', file=sys.stderr)
                    return 1
                if not is_2d and len(parts) != 1:
                    print(f'{kind}: a chain takes a scalar offset '
                          f'(got {spec!r})', file=sys.stderr)
                    return 1
                dx, dy = (parts if is_2d else (parts[0], 0))
                # True lattice pairs: the flat-index (i, (i+d) % N) pairing
                # crosses row boundaries on a 2-D lattice.
                pairs = lattice_lib.displacement_pairs(
                    config.num_sites, config.size_x, config.size_y, dx, dy)
                disp = f'({dx},{dy})' if is_2d else str(dx)
                if kind == 'szsz':
                    from cgs_vmc_jax.ops.observables import SzSzCorrelation
                    operator = SzSzCorrelation(pairs)
                    label = f'SzSz(d={disp})'
                else:
                    from cgs_vmc_jax.ops.observables import (
                        TransverseCorrelation)
                    operator = TransverseCorrelation(
                        pairs, sample_chunk=config.energy_chunk_samples)
                    label = f'SxSx+SySy(d={disp})'
                    # Marshall-gauge correction (see
                    # examples/measure_6x6_observables.py): a state trained
                    # with jx < 0 is the gauge-rotated ground state
                    # U = prod_B sigma^z, which flips Sx,Sy on sublattice B
                    # — for pairs straddling sublattices the physical
                    # transverse correlator is minus the measured one.
                    # Applied PER PAIR as ±1 couplings inside the fused
                    # exchange kernel, so it is exact even when the pair
                    # set mixes same- and cross-sublattice displacements
                    # (odd-length periodic directions).
                    if config.heisenberg_jx < 0:
                        from cgs_vmc_jax.evaluate import evaluate_operator
                        sub = lattice_lib.marshall_sublattice(
                            config.num_sites, config.size_x, config.size_y)
                        gauge = sub[pairs[:, 0]] * sub[pairs[:, 1]]
                        physical_op = TransverseCorrelation(
                            pairs, sample_chunk=config.energy_chunk_samples,
                            pair_signs=gauge)
                        result = evaluate_operator(
                            wf, params, physical_op, config)
                        print(f'{label} physical (Marshall-gauge '
                              f'corrected): {result.mean} +/- '
                              f'{result.error}')
                        print('Acceptance rate: '
                              f'{result.acceptance_rate:.4f}')
                        return 0
            elif observable.startswith('sq:'):
                import numpy as np
                from cgs_vmc_jax.ops.observables import (
                    SpinStructureFactor, chain_positions, square_positions)
                q = [float(v) * np.pi
                     for v in observable.split(':', 1)[1].split(';')]
                if config.size_y > 1:
                    pos = square_positions(config.size_x, config.size_y)
                else:
                    pos = chain_positions(config.num_sites)
                if len(q) != pos.shape[1]:
                    print(f'S(q) needs {pos.shape[1]} momentum component(s)',
                          file=sys.stderr)
                    return 1
                operator = SpinStructureFactor(q, pos)
                label = f'S(q={observable.split(":", 1)[1]}pi)'
            elif observable == 'total_spin2':
                from cgs_vmc_jax import lattice as lattice_lib
                from cgs_vmc_jax.ops.observables import TotalSpinSquared
                sub_mask = None
                if config.heisenberg_jx < 0:
                    # Marshall-gauged state: gauge-correct the exchange
                    # terms per pair (see TotalSpinSquared docstring).
                    sub_mask = lattice_lib.marshall_sublattice(
                        config.num_sites, config.size_x, config.size_y)
                operator = TotalSpinSquared(
                    config.num_sites,
                    sample_chunk=config.energy_chunk_samples,
                    sublattice=sub_mask)
                label = 'Total spin S^2'
            elif observable == 'staggered_m2':
                from cgs_vmc_jax import lattice as lattice_lib
                from cgs_vmc_jax.ops.observables import (
                    StaggeredMagnetizationSquared)
                sub_mask = lattice_lib.marshall_sublattice(
                    config.num_sites, config.size_x, config.size_y)
                operator = StaggeredMagnetizationSquared(sub_mask)
                label = 'Staggered m^2'
            else:
                print(f'Unknown observable {observable!r}', file=sys.stderr)
                return 1
            result = evaluate_operator(wf, params, operator, config)
            print(f'{label}: {result.mean} +/- {result.error}')
            print(f'Acceptance rate: {result.acceptance_rate:.4f}')
        elif args.command == 'evolve' and getattr(args, 'linear_response',
                                                  ''):
            import json
            import numpy as np
            from cgs_vmc_jax.ops import dynamics
            from cgs_vmc_jax.ops.observables import (chain_positions,
                                                     square_positions)
            q = [float(v) * np.pi
                 for v in args.linear_response.split(';')]
            if config.size_y > 1:
                pos = square_positions(config.size_x, config.size_y)
            else:
                pos = chain_positions(config.num_sites)
            if len(q) != pos.shape[1]:
                print(f'--linear_response needs {pos.shape[1]} momentum '
                      'component(s)', file=sys.stderr)
                return 1
            probe = dynamics.FourierSz(q, pos)
            times, corr, _ = dynamics.sampled_linear_response(
                wf, params, hamiltonian, probe, config,
                eps=args.eps, dt=args.dt, n_steps=args.steps)
            omegas = np.linspace(0.0, np.pi * 3, 256)
            spec = dynamics.spectral_function(times, corr, omegas)
            out_path = os.path.join(run_dir, 'linear_response.jsonl')
            with open(out_path, 'w') as f:
                f.write(json.dumps({'q_over_pi': args.linear_response,
                                    'eps': args.eps,
                                    'times': times.tolist(),
                                    'correlator': corr.tolist()}) + '\n')
                f.write(json.dumps({'omegas': omegas.tolist(),
                                    'spectral_function':
                                        spec.tolist()}) + '\n')
            peak = float(omegas[int(np.argmax(spec))])
            print(f'Linear response C(t) over {args.steps} steps of '
                  f'dt={args.dt}; S(q,omega) peak at omega={peak:.4f}')
            print(f'Wrote {out_path}')
        elif args.command == 'evolve':
            import json
            from cgs_vmc_jax.optim.tvmc import TimeEvolution
            evo = TimeEvolution(wf, hamiltonian, config, dt=args.dt,
                                mode=args.mode, integrator=args.integrator)
            from cgs_vmc_jax.sampler import metropolis
            sampler = metropolis.init_sampler_for(
                jax.random.key(config.seed + 1), wf, params, config)
            sampler = jax.jit(lambda s: evo.sweeps(
                params, s, config.num_equilibration_sweeps))(sampler)
            params, sampler, records = evo.evolve(
                params, sampler, args.steps)
            out_path = os.path.join(run_dir, 'evolution.jsonl')
            with open(out_path, 'w') as f:
                for i, rec in enumerate(records):
                    f.write(json.dumps({'t': (i + 1) * args.dt, **rec}) + '\n')
            print(f'Evolved {args.steps} steps of dt={args.dt} ({args.mode} '
                  f'time); trajectory in {out_path}')
            print(f"Final energy: {records[-1]['energy']}")
        else:
            from cgs_vmc_jax.evaluate import evaluate_vector
            psi = evaluate_vector(wf, params, config)
            print(f'Wrote {psi.shape[0]} amplitudes to '
                  f'{run_dir}/wavefunction_epoch_0.txt')
        return 0

    return 1


if __name__ == '__main__':
    sys.exit(main())
