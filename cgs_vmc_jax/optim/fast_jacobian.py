"""Batched-GEMM per-sample Jacobian rows for (symmetrized) conv ansatzes.

The generic `_jacobian_rows` path (optim/sr.py) computes per-sample
gradients with vmap(grad) of a batch-1 forward.  XLA lowers a vmapped
conv WEIGHT gradient as a feature-grouped convolution with one group
per sample — thousands of tiny groups whose cost is per-sample overhead
rather than math.

This module reformulates the SAME network as periodic-pad + im2col
patches + matmuls, with each weight tensor broadcast to a per-sample
copy: the forward becomes batched GEMMs ('cok,ckf->cof'), so one
ordinary vjp with a ones cotangent yields every sample's weight
gradient as the batched-GEMM transpose — the dense matrix-unit shape
the grouped-conv lowering does not produce.  Numerics are
the generic path's: same periodic padding helper, same activation
registry, same signed-logsumexp symmetrization, same dtype casts; rows
come back in `ravel_pytree(params)` order (asserted in
tests/test_fast_jacobian.py against vmap(grad) to f32 tolerance).

Supported: Conv1DNetwork / Conv2DNetwork / ResNet1D / ResNet2D
(plain and bottleneck blocks, stride 1), each optionally wrapped in
SymmetrizedWavefunction (site-permutation orbit x global spin flip),
plus the masked-conv autoregressive model.  `rows_fn_for` returns None
for anything else and callers fall back to the generic path, mirroring
the sampler fast-path registry (sampler/registry.py).

Inside the full SR epoch XLA fused the grouped-conv backward better than
this per-sample broadcast-GEMM chain, whose [M, o, k*k*c] patch tensors
round-trip through device memory, so `config.sr_fast_jacobian` defaults
to False and the module stays a correct (bit-tested) opt-in.  Its time on
an H100 is not measured yet (ROADMAP D3).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cgs_vmc_jax.models import nn
from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_jax.models.conv import (Conv1DNetwork, Conv2DNetwork,
                                     ResNet1D, ResNet2D)
from cgs_vmc_jax.models.pixelcnn import MaskedConv2DAutoregressive
from cgs_vmc_jax.models.symmetry import SymmetrizedWavefunction
from cgs_vmc_jax.ops import logamp


def _patches_2d(x: jax.Array, kernel: int) -> jax.Array:
    """Periodic-pad + im2col.  x: [N, H, W, C] -> [N, H, W, k*k*C] with
    the channel-minor (kh, kw, ci) order that matches reshaping an HWIO
    kernel to [k*k*ci, co]."""
    padded = nn._periodic_pad_2d(x, kernel)
    h, w = x.shape[1], x.shape[2]
    slabs = [padded[:, dh:dh + h, dw:dw + w, :]
             for dh in range(kernel) for dw in range(kernel)]
    return jnp.concatenate(slabs, axis=-1)


def _patches_2d_zero(x: jax.Array, kernel: int) -> jax.Array:
    """Zero-pad ('SAME', odd kernel) + im2col, same (kh, kw, ci) order —
    the causal-conv analog of `_patches_2d` (models/pixelcnn.py pads
    with zeros: periodic wrap would leak raster-future sites)."""
    half = kernel // 2
    padded = jnp.pad(x, ((0, 0), (half, half), (half, half), (0, 0)))
    h, w = x.shape[1], x.shape[2]
    slabs = [padded[:, dh:dh + h, dw:dw + w, :]
             for dh in range(kernel) for dw in range(kernel)]
    return jnp.concatenate(slabs, axis=-1)


def _patches_1d(x: jax.Array, kernel: int) -> jax.Array:
    """Periodic-pad + im2col, 1-D.  x: [N, L, C] -> [N, L, k*C] in the
    channel-minor (k, ci) order that matches reshaping a WIO kernel to
    [k*ci, co]."""
    padded = nn._periodic_pad_1d(x, kernel)
    length = x.shape[1]
    slabs = [padded[:, d:d + length, :] for d in range(kernel)]
    return jnp.concatenate(slabs, axis=-1)


def _orbit_of(c_configs: jax.Array, perms, spin_flip: bool) -> jax.Array:
    """[c, n_sites] -> [c, n_ops, n_sites] symmetry orbit (or trivial)."""
    if perms is not None:
        orbit = c_configs[:, perms]
        if spin_flip:
            orbit = jnp.concatenate([orbit, -orbit], axis=1)
    else:
        orbit = c_configs[:, None, :]
    return orbit


def _symmetrized_head(pre: jax.Array, output_activation: str) -> jax.Array:
    """[c, n_ops] pre-activations -> log|psi| [c] (signed-logsumexp
    orbit average, mirroring SymmetrizedWavefunction.apply)."""
    n_ops = pre.shape[-1]
    amp = logamp.apply_activation(pre, output_activation)
    if n_ops == 1:
        return amp.log[:, 0]
    avg = logamp.sum_terms(amp.sign, amp.log, axis=-1)
    return avg.log - jnp.log(float(n_ops))


def _ps_conv(patches_fn: Callable, layer: dict, h: jax.Array, c: int,
             dtype=jnp.float32, mask=None) -> jax.Array:
    """Periodic conv with PER-SAMPLE weight copies as a batched GEMM.

    layer['w']: [c, *kernel_dims, cin, cout] (leading per-sample axis),
    layer['b']: [c, cout]; h: [c*n, *spatial, cin].  Stride 1.
    mask: optional [k*k*cin, cout] multiplier on the reshaped weights
    (the masked-conv autoregressive family).
    """
    w, b = layer['w'], layer['b']
    x = patches_fn(h, w.shape[1])
    cols = x.reshape(c, -1, x.shape[-1])
    w2 = w.reshape(c, -1, w.shape[-1]).astype(dtype)
    if mask is not None:
        w2 = w2 * mask[None]
    out = jnp.einsum('cok,ckf->cof', cols, w2,
                     preferred_element_type=dtype)
    out = out + b.astype(dtype)[:, None, :]
    return out.reshape(h.shape[:-1] + (w.shape[-1],))


def _conv_forward_per_sample(base, ps, orbit: jax.Array, two_d: bool
                             ) -> jax.Array:
    """log|psi| [c] for Conv1DNetwork/Conv2DNetwork with per-sample
    weights (mirrors their apply term for term: dtype casts, activation
    registry, f32 head sum, signed-logsumexp orbit average)."""
    c, n_ops = orbit.shape[0], orbit.shape[1]
    act = logamp.ACTIVATIONS[base.nonlinearity]
    dtype = base.compute_dtype
    patches_fn = _patches_2d if two_d else _patches_1d
    if two_d:
        h = orbit.reshape(c * n_ops, base.size_x, base.size_y, 1)
    else:
        h = orbit.reshape(c * n_ops, orbit.shape[-1], 1)
    h = h.astype(dtype)
    for i in range(base.num_layers):
        h = _ps_conv(patches_fn, ps[f'conv_{i}'], h, c, dtype)
        if i + 1 != base.num_layers:
            h = act(h).astype(dtype)
    pre = jnp.sum(h.astype(jnp.float32),
                  axis=tuple(range(1, h.ndim))).reshape(c, n_ops)
    return _symmetrized_head(pre, base.output_activation)


def _resnet_forward_per_sample(base, ps, orbit: jax.Array, two_d: bool
                               ) -> jax.Array:
    """log|psi| [c] for ResNet1D/ResNet2D with per-sample weights
    (mirrors models/conv.py apply + nn res/bottleneck blocks, stride 1:
    stem conv, selu two-conv residual blocks or relu 1-k-1 bottleneck
    blocks with identity shortcuts, f32 throughout)."""
    c, n_ops = orbit.shape[0], orbit.shape[1]
    patches_fn = _patches_2d if two_d else _patches_1d
    if two_d:
        h = orbit.reshape(c * n_ops, base.size_x, base.size_y, 1)
    else:
        h = orbit.reshape(c * n_ops, orbit.shape[-1], 1)
    h = h.astype(jnp.float32)
    h = _ps_conv(patches_fn, ps['stem'], h, c)
    for i in range(base.num_blocks):
        bp = ps[f'block_{i}']
        if base.bottleneck:
            t = jax.nn.relu(_ps_conv(patches_fn, bp['reduce'], h, c))
            t = jax.nn.relu(_ps_conv(patches_fn, bp['conv'], t, c))
            t = _ps_conv(patches_fn, bp['expand'], t, c)
        else:
            t = jax.nn.selu(_ps_conv(patches_fn, bp['conv1'], h, c))
            t = _ps_conv(patches_fn, bp['conv2'], t, c)
        h = t + h
    pre = jnp.sum(h, axis=tuple(range(1, h.ndim))).reshape(c, n_ops)
    return _symmetrized_head(pre, base.output_activation)


def _tree_rows(forward_fn: Callable) -> Callable:
    """one_chunk(params, c_configs) from a per-sample-params forward.

    forward_fn(ps, c_configs) -> log|psi| [c], with ps sharing params'
    pytree structure but a leading per-sample axis on every leaf — so the
    vjp's grads flatten in ravel_pytree(params) leaf order by construction.
    """
    def one_chunk(params, c_configs):
        c = c_configs.shape[0]
        ps = jax.tree.map(
            lambda leaf: jnp.broadcast_to(leaf, (c,) + leaf.shape), params)
        _, vjp = jax.vjp(lambda p: forward_fn(p, c_configs), ps)
        (grads,) = vjp(jnp.ones((c,), jnp.float32))
        leaves = jax.tree_util.tree_leaves(grads)
        return jnp.concatenate(
            [leaf.reshape(c, -1).astype(jnp.float32) for leaf in leaves],
            axis=1)
    return one_chunk


def _pixelcnn_forward_per_sample(model: MaskedConv2DAutoregressive,
                                 masks, ps, configs: jax.Array
                                 ) -> jax.Array:
    """log|psi| [c] for the masked-conv AR model with per-sample weight
    copies (params-structured tree ps).  Mirrors
    MaskedConv2DAutoregressive._logits + the sector-projected chain rule
    term for term (zero padding, act between layers, f32)."""
    c = configs.shape[0]
    act = logamp.ACTIVATIONS[model.nonlinearity]
    h = configs.astype(jnp.float32).reshape(c, model.size_x, model.size_y, 1)
    last = len(masks) - 1
    for i, mask in enumerate(masks):
        h = _ps_conv(_patches_2d_zero, ps[f'conv_{i}'], h, c, mask=mask)
        if i != last:
            h = act(h)
    logits = h.reshape(c, model.num_sites)
    log_p = AutoregressiveSpinModel.conditional_log_p_from_logits(
        logits, configs)
    return 0.5 * jnp.sum(log_p, axis=-1)


def _chunked(one_chunk: Callable) -> Callable:
    """Wraps a per-chunk rows fn with the pad-and-lax.map chunking."""
    def rows(params, configs, chunk: int) -> jax.Array:
        batch = configs.shape[0]
        if chunk and batch > chunk:
            n_chunks = -(-batch // chunk)
            pad = n_chunks * chunk - batch
            if pad:
                filler = jnp.broadcast_to(configs[:1],
                                          (pad, configs.shape[-1]))
                configs_p = jnp.concatenate([configs, filler], axis=0)
            else:
                configs_p = configs
            slices = configs_p.reshape(n_chunks, chunk, configs.shape[-1])
            out = jax.lax.map(lambda s: one_chunk(params, s), slices)
            return out.reshape(-1, out.shape[-1])[:batch]
        return one_chunk(params, configs)
    return rows


def rows_fn_for(wf) -> Optional[Callable]:
    """Fast per-sample Jacobian for `wf`, or None if unsupported.

    Returns fn(params, configs, chunk) -> [batch, P] f32 rows in
    ravel_pytree(params) order.

    Supported families: (symmetrized) Conv1DNetwork / Conv2DNetwork /
    ResNet1D / ResNet2D at stride 1, and the masked-conv autoregressive
    model (same im2col-GEMM trick with zero padding and the
    sector-projected chain-rule head).
    """
    if isinstance(wf, MaskedConv2DAutoregressive):
        # Host numpy (DEVELOPMENT.md constant rule) — pure GEMM operands.
        masks = [np.asarray(m).reshape(-1, m.shape[-1]) for m in wf.masks]

        def pixelcnn_fwd(ps, c_configs):
            return _pixelcnn_forward_per_sample(wf, masks, ps, c_configs)
        return _chunked(_tree_rows(pixelcnn_fwd))
    perms = None
    spin_flip = False
    base = wf
    if isinstance(wf, SymmetrizedWavefunction):
        perms, spin_flip, base = wf.perms, wf.spin_flip, wf._wf
    out_act = getattr(base, 'output_activation', None)
    if out_act not in logamp.ACTIVATIONS and out_act != 'exp':
        return None
    if isinstance(base, (Conv1DNetwork, Conv2DNetwork)):
        two_d = isinstance(base, Conv2DNetwork)

        def conv_fwd(ps, c_configs):
            return _conv_forward_per_sample(
                base, ps, _orbit_of(c_configs, perms, spin_flip), two_d)
        return _chunked(_tree_rows(conv_fwd))
    if isinstance(base, (ResNet1D, ResNet2D)):
        if base.conv_stride != 1:
            return None                     # strided shortcut: generic path
        two_d = isinstance(base, ResNet2D)

        def resnet_fwd(ps, c_configs):
            return _resnet_forward_per_sample(
                base, ps, _orbit_of(c_configs, perms, spin_flip), two_d)
        return _chunked(_tree_rows(resnet_fwd))
    return None
