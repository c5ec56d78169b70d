"""SpinTransformer ansatz (models/attention.py).

Oracles: a naive per-head numpy attention reimplementation for the
fused-QKV/reshape plumbing; permutation invariance with the positional
embedding zeroed (structural identity of token attention + mean
pooling); descent + SR convergence on the N=8 chain.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.models.attention import SpinTransformer, _layernorm
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

N = 8


def _configs(key, batch, n=N):
    return basis.random_configurations(key, n, batch)


def test_registry_apply_shapes_and_sign():
    cfg = Config(num_sites=N, wavefunction_type='transformer',
                 num_attention_layers=2, attention_dim=16,
                 num_attention_heads=4)
    wf = build_wavefunction(cfg)
    assert isinstance(wf, SpinTransformer)
    params = wf.init(jax.random.key(1))
    configs = _configs(jax.random.key(2), 32)
    amp = jax.jit(wf.apply)(params, configs)
    assert amp.log.shape == (32,)
    assert np.isfinite(np.asarray(amp.log)).all()
    np.testing.assert_array_equal(np.asarray(amp.sign), 1.0)


def test_attention_matches_naive_per_head():
    """The fused-QKV einsum attention equals a per-head numpy loop."""
    wf = SpinTransformer(N, num_layers=1, model_dim=8, num_heads=2)
    params = wf.init(jax.random.key(3))
    block = params['block_0']
    h = jax.random.normal(jax.random.key(4), (5, N, 8), jnp.float32)

    got = np.asarray(wf._attention(block, h))

    x = np.asarray(_layernorm(block['ln1'], h), np.float64)
    qkv = x @ np.asarray(block['qkv']['w'], np.float64) + np.asarray(
        block['qkv']['b'], np.float64)
    q, k, v = np.split(qkv, 3, axis=-1)            # [5, N, 8] each
    dh = 8 // 2
    outs = []
    for head in range(2):
        qs = q.reshape(5, N, 2, dh)[:, :, head]
        ks = k.reshape(5, N, 2, dh)[:, :, head]
        vs = v.reshape(5, N, 2, dh)[:, :, head]
        logits = np.einsum('bqd,bkd->bqk', qs, ks) / np.sqrt(dh)
        attn = np.exp(logits - logits.max(-1, keepdims=True))
        attn /= attn.sum(-1, keepdims=True)
        outs.append(np.einsum('bqk,bkd->bqd', attn, vs))
    merged = np.stack(outs, axis=2).reshape(5, N, 8)
    want = merged @ np.asarray(block['attn_out']['w'], np.float64) + \
        np.asarray(block['attn_out']['b'], np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_permutation_invariant_without_pos_embed():
    """Token attention + mean pooling is permutation invariant; only the
    positional embedding breaks it.  With pos_embed zeroed, permuting the
    sites must leave logψ unchanged."""
    wf = SpinTransformer(N, num_layers=2, model_dim=16, num_heads=4)
    params = wf.init(jax.random.key(5))
    params['pos_embed'] = jnp.zeros_like(params['pos_embed'])
    configs = _configs(jax.random.key(6), 16)
    perm = np.random.default_rng(7).permutation(N)
    base = wf.apply(params, configs).log
    permuted = wf.apply(params, configs[:, perm]).log
    np.testing.assert_allclose(np.asarray(base), np.asarray(permuted),
                               rtol=1e-5, atol=1e-5)
    # ... and with the real (nonzero) positional embedding it must NOT be.
    params2 = wf.init(jax.random.key(5))
    base2 = wf.apply(params2, configs).log
    permuted2 = wf.apply(params2, configs[:, perm]).log
    assert np.abs(np.asarray(base2) - np.asarray(permuted2)).max() > 1e-6


@pytest.mark.slow
def test_gradients_flow_to_every_leaf():
    wf = SpinTransformer(N, num_layers=1, model_dim=8, num_heads=2)
    params = wf.init(jax.random.key(8))
    configs = _configs(jax.random.key(9), 64)
    grads = jax.grad(lambda p: jnp.sum(wf.apply(p, configs).log))(params)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    for path, leaf in flat:
        assert np.isfinite(np.asarray(leaf)).all(), path
        assert np.abs(np.asarray(leaf)).max() > 0, (
            f'zero gradient at {jax.tree_util.keystr(path)}')


def test_symmetrized_transformer_composes():
    cfg = Config(num_sites=16, size_x=4, size_y=4,
                 wavefunction_type='transformer', num_attention_layers=1,
                 attention_dim=8, num_attention_heads=2, symmetrize=True)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(10))
    configs = _configs(jax.random.key(11), 8, n=16)
    amp = jax.jit(wf.apply)(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()


@pytest.mark.slow
def test_transformer_sr_converges_on_chain():
    """Dense minSR drives the transformer to ~1% of the N=8 chain ED
    energy (E0 = -3.6510934) within a short budget."""
    cfg = Config(num_sites=N, wavefunction_type='transformer',
                 num_attention_layers=1, attention_dim=16,
                 num_attention_heads=2,
                 wavefunction_optimizer_type='SR',
                 batch_size=256, num_batches_per_epoch=2,
                 num_equilibration_sweeps=3, num_monte_carlo_sweeps=1,
                 learning_rates=[0.05, 0.02], learning_rate_stops=[80],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-3, sr_solver='dense',
                 sr_delta_clip=1.0, seed=13)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(14))
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(150):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
    late = np.mean(energies[-10:])
    assert np.isfinite(energies).all()
    assert abs(late - (-3.6510934)) / 3.6510934 < 0.02, (
        f'late mean {late:.4f}')
