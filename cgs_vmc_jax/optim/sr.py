"""Stochastic reconfiguration (natural-gradient VMC) optimizer.

NEW capability — the reference has no SR (its ground-state registry is
{EnergyGradient, LogOverlapITSWO, ITSWO}, cgs_vmc/training.py:913-917);
required by the rebuild spec (SURVEY.md §7 design stance #6).

Solves  (S + eps·I) · delta = g  where
  S_kj = <O_k O_j> − <O_k><O_j>,     O_k = d logψ / d θ_k,
  g_k  = <E_loc O_k> − <E_loc><O_k>.

Two solvers:

 * 'dense' (default): materialize the centered
   log-derivative Jacobian Ō [samples, params], move the solve to SAMPLE
   space with the push-through identity
       δ = Ōᵀ (Ō Ōᵀ / M + ε I_M)⁻¹ ε_loc / M,
   and Cholesky-solve the [M, M] system — two large matmuls plus a
   direct solve, numerically robust where iterative CG is wrecked by
   reduced-precision matmul rounding.  This is the "minSR" formulation (Chen & Heyl
   2023) and is exact for ε > 0.
 * 'cg': matrix-free S·v through paired jvp/vjp, conjugate gradients on
   parameter pytrees — O(params) memory, for models too large to
   materialize the Jacobian.

Both paths aggregate over the 'chains' mesh axis; the dense path
all-gathers the per-device Jacobian shards, the CG path pmeans each
matvec over the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.flatten_util
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.optim import common, fast_jacobian
from cgs_vmc_jax.optim.common import TrainState
from cgs_vmc_jax.sampler import metropolis


def _spd_cg_solve(a_matrix, b, tol: float, maxiter: int):
    """Plain CG on an explicit SPD matrix (replicated, f32 matvecs).

    Used by the 'dense_cg' solver; every device holds the identical
    assembled system so no collectives are needed inside the loop.  The
    matvec is pinned to HIGHEST (full f32) regardless of the caller's
    sr_matmul_precision — CG residual recurrences amplify matmul
    rounding, and at [M, M]·[M] size the matvec cost is negligible."""
    x0 = jnp.zeros_like(b)
    b_norm2 = jnp.vdot(b, b)
    tol2 = (tol ** 2) * b_norm2

    def cond(s):
        _, _, _, rs, it = s
        return jnp.logical_and(it < maxiter, rs > tol2)

    def body(s):
        x, r, p, rs, it = s
        with jax.default_matmul_precision('highest'):
            ap = a_matrix @ p
        alpha = rs / (jnp.vdot(p, ap) + 1e-38)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / (rs + 1e-38)) * p
        return (x, r, p, rs_new, it + 1)

    state0 = (x0, b, b, b_norm2, jnp.asarray(0, jnp.int32))
    x, _, _, _, _ = lax.while_loop(cond, body, state0)
    return x


def _jacobian_rows(fn, flat_params, configs, chunk: int):
    """Per-sample gradient rows via vmap(grad), optionally lax.map'd in
    `chunk`-sample slices so backward-pass activation memory is bounded
    by the chunk instead of the full sample count (× the symmetry-orbit
    size for projected ansatzes)."""
    grad_rows = jax.vmap(jax.grad(fn), in_axes=(None, 0))
    if chunk and configs.shape[0] > chunk:
        # Pad to a chunk multiple (padded rows dropped) instead of silently
        # falling back to the unchunked vmap whose activation memory the
        # chunk setting exists to bound.
        batch = configs.shape[0]
        n_chunks = -(-batch // chunk)
        pad = n_chunks * chunk - batch
        if pad:
            filler = jnp.broadcast_to(configs[:1], (pad, configs.shape[-1]))
            padded = jnp.concatenate([configs, filler], axis=0)
        else:
            padded = configs
        slices = padded.reshape(n_chunks, chunk, configs.shape[-1])
        rows = jax.lax.map(lambda c: grad_rows(flat_params, c), slices)
        return rows.reshape(-1, rows.shape[-1])[:batch]
    return grad_rows(flat_params, configs)


class StochasticReconfiguration:
    """Ground-state optimizer 'SR'."""

    name = 'SR'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config):
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        self.optax_opt = common.make_optax_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def init_state(self, key: jax.Array, n_local_chains: Optional[int] = None
                   ) -> TrainState:
        params_key, sampler_key = jax.random.split(key)
        params = self.wf.init(params_key)
        sampler = metropolis.init_sampler_for(
            sampler_key, self.wf, params, self.config,
            n_local_chains)
        return TrainState(
            params=params,
            opt_state=self.optax_opt.init(params),
            sampler=sampler,
            epoch=jnp.zeros((), jnp.int32),
            extra={},
        )

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        params = state.params

        sampler = metropolis.reset_stats(state.sampler)
        # Params changed since last epoch's sweeps wrote the amplitude cache.
        sampler = metropolis.refresh_amplitudes(wf, params, sampler)
        sampler = self.sweeps(params, sampler,
                              cfg.num_equilibration_sweeps)

        # Collect num_batches_per_epoch decorrelated sample batches.
        def collect(smp, _):
            configs = smp.configs
            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            return smp, configs

        sampler, batches = lax.scan(
            collect, sampler, None, length=cfg.num_batches_per_epoch)
        all_configs = batches.reshape(-1, cfg.num_sites)  # [M_local, n]
        m_local = all_configs.shape[0]

        amp = wf.apply(params, all_configs)
        e_loc = lax.stop_gradient(
            ham.local_value(wf, params, all_configs, amp))
        e_mean = common.pmean(jnp.mean(e_loc), axis_name)
        e2_mean = common.pmean(jnp.mean(jnp.abs(e_loc) ** 2), axis_name)

        # Residual hook: subclasses may augment the solver's local values
        # (e.g. the excited-state penalty adds λ·<s>·r, optim/excited.py)
        # while the reported energy stays the raw <E_loc>.
        e_solver, extra_state, extra_metrics = self._solver_residual(
            params, all_configs, amp, e_loc, state, axis_name)
        e_solver_mean = common.pmean(jnp.mean(e_solver), axis_name)

        params, opt_state, residual_norm, grad_e = self.update_from_samples(
            params, state.opt_state, state.epoch, all_configs, e_solver,
            e_solver_mean, axis_name)

        metrics = {
            'energy': jnp.real(e_mean),
            'energy_variance': e2_mean - jnp.abs(e_mean) ** 2,
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
            'grad_norm': common.grad_global_norm(grad_e),
            'sr_residual_norm': residual_norm,
            **extra_metrics,
        }
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            sampler=sampler,
            epoch=state.epoch + 1,
            extra=extra_state,
        )
        return new_state, metrics

    def update_from_samples(self, params, opt_state, epoch, all_configs,
                            e_solver, e_solver_mean=None,
                            axis_name: Optional[str] = None):
        """Solve + gate + apply one SR step from a pre-sampled batch.

        The tail of `epoch` — solver dispatch, non-finite fallback to the
        raw gradient, residual-based rejection, trust-region clip, and the
        optax update — as a public method, so split-program drivers that
        own their sampling loop (examples/heisenberg_12x12_deep.py,
        examples/heisenberg_6x6_transformer.py) reuse the exact gating
        logic instead of re-implementing it around the private solvers.

        Returns (new_params, new_opt_state, residual_norm, grad_e).
        """
        cfg = self.config
        if e_solver_mean is None:
            e_solver_mean = common.pmean(jnp.mean(e_solver), axis_name)
        m_local = all_configs.shape[0]

        def log_fn(p):
            return self.wf.apply(p, all_configs).log

        solver = cfg.sr_solver
        if solver in ('dense', 'dense_cg'):
            delta, grad_e, residual_norm = self._dense_solve(
                all_configs, params, e_solver, e_solver_mean, axis_name,
                use_cg=(solver == 'dense_cg'))
        elif solver == 'sample_cg':
            delta, grad_e, residual_norm = self._sample_cg_solve(
                all_configs, params, e_solver, e_solver_mean, axis_name)
        else:
            delta, grad_e, residual_norm = self._cg_solve(
                log_fn, params, e_solver, e_solver_mean, m_local, axis_name)

        # Robustness: non-finite solve falls back to the raw gradient;
        # trust-region clip on the natural-gradient norm; optionally skip
        # the update entirely when the solve residual is large relative to
        # the gradient (a bad natural-gradient direction at full step size
        # can undo hundreds of epochs).
        finite = jnp.all(jnp.asarray(
            [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree.leaves(delta)]))
        delta = jax.tree.map(
            lambda d, g: jnp.where(finite, d, g), delta, grad_e)
        if cfg.sr_reject_residual > 0:
            ok = jnp.logical_or(
                jnp.logical_not(finite),  # fallback grad is always usable
                residual_norm < cfg.sr_reject_residual
                * (common.grad_global_norm(grad_e) + 1e-12))
            delta = jax.tree.map(
                lambda d: jnp.where(ok, d, jnp.zeros_like(d)), delta)
        delta_norm = common.grad_global_norm(delta)
        clip = jnp.minimum(1.0, cfg.sr_delta_clip / (delta_norm + 1e-12))
        delta = jax.tree.map(lambda d: d * clip, delta)

        params, opt_state = self.optax_opt.update(
            delta, opt_state, params, epoch)
        return params, opt_state, residual_norm, grad_e

    def _solver_residual(self, params, all_configs, amp, e_loc, state,
                         axis_name):
        """Hook: (solver local values, new extra dict, extra metrics).

        The base optimizer solves against the plain local energies;
        subclasses may add penalty terms expressible as extra local
        values over the SAME samples (any force of covariance form
        cov(w, O) folds into minSR as e_loc + w)."""
        del params, all_configs, amp, axis_name
        return e_loc, dict(state.extra), {}

    # ------------------------------------------------------------------
    # Solvers.
    # ------------------------------------------------------------------

    def _dense_solve(self, all_configs, params, e_loc, e_mean, axis_name,
                     use_cg: bool = False):
        """Sample-space minSR: δ = Ōᵀ (Ō Ōᵀ/M + εI)⁻¹ ε̄ / M.

        Ō is the centered log-derivative Jacobian; all heavy lifting is
        two large matmuls + a direct solve of the small [M, M] system.

        use_cg ('dense_cg'): solve the assembled SPD system by plain CG
        instead of Cholesky.  The relative diagonal shift bounds the
        condition number at ~(1 + 1/sr_diag_shift) so CG converges in
        O(sqrt(1/shift)) iterations of one [M, M] matvec each (~67 MB of
        device-memory traffic at M=4096) — where XLA's blocked Cholesky
        pays a serial panel factorization that no matmul throughput
        hides.  Accuracy is set by sr_cg_tol; the natural-gradient
        direction is the same solve either way.
        """
        cfg = self.config
        flat_params, unravel = jax.flatten_util.ravel_pytree(params)
        wf = self.wf
        is_complex = jnp.iscomplexobj(e_loc)

        # Per-sample gradient rows via vmap(grad): one batched backward
        # pass total.  (jacrev of the batched log would do O(M²) work —
        # the jacobian's block structure is invisible to XLA.)
        def single_log(p_flat, config):
            return wf.apply(unravel(p_flat), config[None, :]).log[0]

        def jac_rows(fn, configs):
            return _jacobian_rows(fn, flat_params, configs,
                                  cfg.sr_jacobian_chunk)

        def center_and_gather(rows):
            rows = rows - jnp.mean(rows, axis=0, keepdims=True)
            if axis_name is not None:
                # Gather shards so every device solves the identical global
                # system (the [M, M] solve is tiny next to the matmuls);
                # re-center with the GLOBAL mean.
                rows = jax.lax.all_gather(rows, axis_name, axis=0,
                                          tiled=True)
                rows = rows - jnp.mean(rows, axis=0, keepdims=True)
            return rows

        if is_complex:
            # Complex O_k = ∂log|ψ| + i·∂phase with REAL parameters: the
            # metric S = Re⟨O*O⟩c and force f = Re⟨O*(E−Ē)⟩ are exactly
            # the real least-squares problem over STACKED rows
            # [Ō_re; Ō_im] · δ ≈ [Re ε; Im ε] — so the push-through /
            # Cholesky machinery below applies unchanged with a [2M, 2M]
            # sample-space system (divisor stays M, the sample count).
            jac_re = jac_rows(lambda p, c: single_log(p, c).real,
                              all_configs)
            jac_im = jac_rows(lambda p, c: single_log(p, c).imag,
                              all_configs)
            jac = jnp.concatenate(
                [center_and_gather(jac_re), center_and_gather(jac_im)],
                axis=0)                                     # [2M, P]
            eps_c = e_loc - e_mean
            if axis_name is not None:
                eps_c = jax.lax.all_gather(eps_c, axis_name, axis=0,
                                           tiled=True)
            eps = jnp.concatenate([jnp.real(eps_c), jnp.imag(eps_c)])
            m_global = jac.shape[0] // 2
        else:
            # Batched-GEMM rows for (symmetrized) conv ansatzes: per-sample
            # weight grads instead of vmap(grad)'s grouped-conv lowering
            # (optim/fast_jacobian.py; opt-in via sr_fast_jacobian).
            fast = (fast_jacobian.rows_fn_for(wf)
                    if getattr(cfg, 'sr_fast_jacobian', True) else None)
            if fast is not None:
                raw = fast(params, all_configs, cfg.sr_jacobian_chunk)
            else:
                raw = jac_rows(single_log, all_configs)
            jac = center_and_gather(raw)                    # [M_local, P]
            eps = e_loc - e_mean                            # [M_local]
            if axis_name is not None:
                eps = jax.lax.all_gather(eps, axis_name, axis=0, tiled=True)
            m_global = jac.shape[0]

        n_rows = jac.shape[0]  # M for real logs, 2M for complex (stacked)
        with jax.default_matmul_precision(cfg.sr_matmul_precision):
            t_matrix = (jac @ jac.T) / m_global             # [rows, rows]
            # Scale-invariant regularization: shift relative to the mean
            # diagonal so conditioning doesn't depend on gradient scale
            # (an absolute shift under-regularizes large-Jacobian models
            # and the f32 Cholesky goes NaN).
            diag_scale = jnp.mean(jnp.diagonal(t_matrix)) + 1e-12
            t_matrix = t_matrix + (cfg.sr_diag_shift * diag_scale) * jnp.eye(
                n_rows, dtype=t_matrix.dtype)
            rhs = eps / m_global
            if use_cg:
                y = _spd_cg_solve(t_matrix, rhs,
                                  cfg.sr_cg_tol, cfg.sr_cg_maxiter)
            else:
                y = jax.scipy.linalg.solve(t_matrix, rhs,
                                           assume_a='pos')  # [M]
            # One back-GEMM for δ = Jᵀy, g = Jᵀ(ε̄/M), AND the
            # parameter-space monitoring residual: with T the shifted
            # sample-space matrix, Sδ + ε_eff δ − g = Jᵀ(Ty − ε̄/M), so
            # stacking the three right-hand vectors reads the [M, P]
            # Jacobian once instead of three times.
            r_sample = t_matrix @ y - rhs
            combo = jac.T @ jnp.stack([y, rhs, r_sample], axis=1)  # [P, 3]

        delta = unravel(combo[:, 0])
        grad_e = unravel(combo[:, 1])
        residual_norm = jnp.linalg.norm(combo[:, 2])
        return delta, grad_e, residual_norm

    def _sample_cg_solve(self, all_configs, params, e_loc, e_mean,
                         axis_name):
        """minSR at scale: the SAME sample-space system as `_dense_solve`
        — (J Jᵀ/M + εI) y = ε̄/M, δ = Jᵀy — but solved by CG with the
        Jacobian kept SHARDED over the chains axis.  Per iteration:
        u = psum(J_locᵀ x_loc) ∈ R^P over the mesh, then J_loc u — two local
        GEMMs + one [P] collective.  Memory is O(M_local × P) per device
        (vs `_dense_solve`'s all-gathered O(M_global × P)), and for
        k ≪ M iterations the FLOPs (2kMP) undercut the explicit [M, M]
        assembly (M²P).  Rounding behaves: both matvec GEMMs act on the
        explicitly centered Jacobian, unlike the parameter-space `_cg_solve`
        whose jvp/vjp chains re-derive it each pass (ROADMAP 'dense SR at
        scale' item)."""
        cfg = self.config
        flat_params, unravel = jax.flatten_util.ravel_pytree(params)
        wf = self.wf
        is_complex = jnp.iscomplexobj(e_loc)

        def single_log(p_flat, config):
            return wf.apply(unravel(p_flat), config[None, :]).log[0]

        def psum(x):
            return x if axis_name is None else jax.lax.psum(x, axis_name)

        n_dev = 1 if axis_name is None else jax.lax.psum(1, axis_name)
        m_global = all_configs.shape[0] * n_dev

        def center(rows):
            # Global column means without gathering rows.
            mean = psum(jnp.sum(rows, axis=0, keepdims=True)) / m_global
            return rows - mean

        eps_c = e_loc - e_mean
        chunk = cfg.sr_jacobian_chunk
        if is_complex:
            jac_re = _jacobian_rows(lambda p, c: single_log(p, c).real,
                                    flat_params, all_configs, chunk)
            jac_im = _jacobian_rows(lambda p, c: single_log(p, c).imag,
                                    flat_params, all_configs, chunk)
            jac = jnp.concatenate([center(jac_re), center(jac_im)],
                                  axis=0)                   # [2M_loc, P]
            b = jnp.concatenate([jnp.real(eps_c), jnp.imag(eps_c)])
        else:
            # Same batched-GEMM rows as `_dense_solve` (opt-in,
            # optim/fast_jacobian.py).
            fast = (fast_jacobian.rows_fn_for(wf)
                    if getattr(cfg, 'sr_fast_jacobian', True) else None)
            if fast is not None:
                raw = fast(params, all_configs, chunk)
            else:
                raw = _jacobian_rows(single_log, flat_params,
                                     all_configs, chunk)
            jac = center(raw)                               # [M_loc, P]
            b = eps_c
        b = b / m_global

        # Scale-invariant shift relative to the mean diagonal of JJᵀ/M:
        # mean_i(||row_i||²/M) = Σ||rows||² / (n_rows_global · M).
        n_rows_global = jac.shape[0] * n_dev
        diag_scale = psum(jnp.sum(jac * jac)) / (n_rows_global * m_global)
        shift = cfg.sr_diag_shift * (diag_scale + 1e-12)

        with jax.default_matmul_precision(cfg.sr_matmul_precision):
            def matvec(x_loc):
                u = psum(jac.T @ x_loc)                     # [P] replicated
                return jac @ u / m_global + shift * x_loc

            def dot(a_loc, b_loc):
                return psum(jnp.vdot(a_loc, b_loc))

            # Plain CG with psum'd inner products (jax.scipy's cg would
            # compute shard-local dots — wrong under shard_map).
            x0 = jnp.zeros_like(b)
            r0 = b  # x0 = 0
            state0 = (x0, r0, r0, dot(r0, r0), jnp.asarray(0, jnp.int32))
            b_norm2 = dot(b, b)
            tol2 = (cfg.sr_cg_tol ** 2) * b_norm2

            def cond(s):
                _, _, _, rs, it = s
                return jnp.logical_and(it < cfg.sr_cg_maxiter, rs > tol2)

            def body(s):
                x, r, p, rs, it = s
                ap = matvec(p)
                alpha = rs / (dot(p, ap) + 1e-38)
                x = x + alpha * p
                r = r - alpha * ap
                rs_new = dot(r, r)
                p = r + (rs_new / (rs + 1e-38)) * p
                return (x, r, p, rs_new, it + 1)

            y, r, _, _, _ = lax.while_loop(cond, body, state0)

            delta_flat = psum(jac.T @ y)                    # δ = Jᵀ y
            grad_flat = psum(jac.T @ b)                     # g = Jᵀ ε̄/M
            # Parameter-space residual: Jᵀ(sample residual) = Sδ + εδ − g.
            resid_param = psum(jac.T @ (matvec(y) - b))
        residual_norm = jnp.linalg.norm(resid_param)
        return unravel(delta_flat), unravel(grad_flat), residual_norm

    def _cg_solve(self, log_fn, params, e_loc, e_mean, m_local, axis_name):
        """Matrix-free CG in parameter space (O(params) memory).

        Complex logs: with real parameters θ the metric is
        S = Re⟨O†O⟩c = (J_reᵀJ_re + J_imᵀJ_im)/M and the force
        f = Re⟨O*(E−Ē)⟩ = (J_reᵀ Re ε + J_imᵀ Im ε)/M, so the matvec is
        the sum of the real and imaginary parts' matvecs — each built
        from jvp/vjp of a REAL-valued function (no complex cotangents).
        Real-log ansatzes take the single-part path unchanged.
        """
        cfg = self.config
        out = jax.eval_shape(log_fn, params)
        if jnp.issubdtype(out.dtype, jnp.complexfloating):
            parts = [lambda p: jnp.real(log_fn(p)),
                     lambda p: jnp.imag(log_fn(p))]
            eps_parts = [jnp.real(e_loc - e_mean), jnp.imag(e_loc - e_mean)]
        else:
            parts = [log_fn]
            eps_parts = [jnp.real(e_loc - e_mean)]

        jvp_fns, jt_fns = [], []
        for part in parts:
            _, jvp_fn = jax.linearize(part, params)
            _, pullback = jax.vjp(part, params)
            jvp_fns.append(jvp_fn)
            jt_fns.append(
                lambda w, pb=pullback: common.pmean(pb(w)[0], axis_name))

        def tree_sum(trees):
            out = trees[0]
            for t in trees[1:]:
                out = jax.tree.map(jnp.add, out, t)
            return out

        grad_e = tree_sum([jt(eps / m_local)
                           for jt, eps in zip(jt_fns, eps_parts)])

        def matvec(v):
            # Algebraically centered: S v = <O·(jv − <jv>)> exactly —
            # avoids the large-value cancellation that amplifies
            # reduced-precision matmul rounding into CG divergence.
            svs = []
            for jvp_fn, jt in zip(jvp_fns, jt_fns):
                jv = jvp_fn(v)
                jv_mean = common.pmean(jnp.mean(jv), axis_name)
                svs.append(jt((jv - jv_mean) / m_local))
            sv = tree_sum(svs)
            return jax.tree.map(
                lambda a, c: a + cfg.sr_diag_shift * c, sv, v)

        delta, _ = jax.scipy.sparse.linalg.cg(
            matvec, grad_e, tol=cfg.sr_cg_tol, maxiter=cfg.sr_cg_maxiter)
        residual = jax.tree.map(jnp.subtract, matvec(delta), grad_e)
        return delta, grad_e, common.grad_global_norm(residual)
