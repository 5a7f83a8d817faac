"""Optimizers with optax's hyperparameters and update rules.

``torch.optim.AdamW`` and ``optax.adamw`` apply the same update rule: Adam
moments with bias correction, eps added to the square root of the second
moment, and weight decay decoupled from the gradient and taken on the
parameter before the step. Their defaults differ (torch decays by 1e-2,
optax by 1e-4), so ``adamw`` passes every hyperparameter with optax's
default.

``adafactor`` is optax's Adafactor, not ``torch.optim.Adafactor`` (whose
rule differs: relative step sizes, no block-RMS clipping). optax applies
its rules to the leaves of the JAX param tree, where one leaf stacks a
weight of every layer (q is ``[n_layers, d_model, H, D]``): its factored
second moment reduces over the leaf's two largest dims, and its clipping
and parameter scale take the RMS of the whole stacked leaf. So the
optimizer works on param groups that each hold one JAX leaf
(``models.jax_leaf_groups``), every tensor viewed in its JAX shape (a
``stacked`` group's tensors are the slices of its leading axis); a group
without a ``shape`` takes each tensor as a leaf of its own.

On a device mesh the parameters are DTensors and both optimizers run as
they are: AdamW is elementwise, and Adafactor's stacked leaf, its factored
means over dims the mesh shards and its block RMS are DTensor ops, whose
pending partial sums DTensor reduces before they are used
(``tests/test_torch_mesh_adafactor.py`` holds it to the single-process
optimizer).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> Callable[[Iterable], torch.optim.AdamW]:
    """Counterpart of ``optax.adamw``: a factory that builds a
    ``torch.optim.AdamW`` over the given parameters or param groups, with
    optax's defaults. ``make_train_fns`` calls it once in its
    ``init_fn``."""
    def make(params) -> torch.optim.AdamW:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make


def _decay_rate_pow(i: int, exponent: float) -> float:
    """optax's second-moment decay at step i, in fp32: 1 - (i+1)^-exp."""
    t = np.float32(i + 1)
    return float(np.float32(1.0) - t ** np.float32(-exponent))


def factored_dims(shape, factored: bool, min_dim_size_to_factor: int
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dim of ``shape`` (by ``np.argsort``), or None where the second
    largest is under ``min_dim_size_to_factor``."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(torch.optim.Optimizer):
    """optax's ``adafactor`` chain, in its order: ``scale_by_factored_rms``
    → ``clip_by_block_rms`` → ``scale_by_learning_rate`` →
    ``scale_by_param_block_rms`` → ``ema`` (momentum) →
    ``add_decayed_weights`` → ``scale(-1)``, then ``apply_updates``.

    The second-moment state (``v_row``/``v_col``, or ``v`` where a leaf is
    not factored), in the leaf's JAX shape, is stored in the parameter's
    dtype after fp32 arithmetic against the decay, as optax stores it; it
    lives in the state of the leaf's first tensor. The update runs in the
    parameter's dtype and the parameter takes ``p + u`` cast back to its
    dtype. Build it through ``adafactor``."""

    def __init__(self, params, learning_rate: Optional[float],
                 min_dim_size_to_factor: int, decay_rate: float,
                 decay_offset: int, multiply_by_parameter_scale: bool,
                 clipping_threshold: Optional[float],
                 momentum: Optional[float], dtype_momentum: torch.dtype,
                 weight_decay_rate: Optional[float], eps: float,
                 factored: bool,
                 weight_decay_mask: Optional[Callable[[str], bool]]):
        super().__init__(params, dict(
            learning_rate=learning_rate,
            min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            dtype_momentum=dtype_momentum,
            weight_decay_rate=weight_decay_rate, eps=eps,
            factored=factored, weight_decay_mask=weight_decay_mask))

    @staticmethod
    def _leaves(group) -> List[Tuple[list, tuple, bool, str]]:
        """(tensors, JAX shape of the leaf, stacked, name) per leaf."""
        params = group["params"]
        if "shape" in group:
            return [(params, tuple(group["shape"]),
                     bool(group.get("stacked")), group.get("name", ""))]
        return [([p], tuple(p.shape), False, "") for p in params]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for tensors, shape, stacked, name in self._leaves(group):
                if all(p.grad is None for p in tensors):
                    continue
                if any(p.grad is None for p in tensors):
                    raise ValueError(f"leaf {name!r}: some of its tensors "
                                     f"have no gradient")
                self._update_leaf(group, tensors, shape, stacked, name)
        return loss

    def _update_leaf(self, hp, tensors, shape, stacked, name):
        """optax's per-leaf update on the leaf in its JAX shape: a stacked
        leaf's gradients are stacked (one copy), its state is kept whole
        with its first tensor, and the update lands in every tensor in one
        multi-tensor add."""
        views = [p.view(shape[1:] if stacked else shape) for p in tensors]
        grads = [p.grad.view(v.shape) for p, v in zip(tensors, views)]
        g = torch.stack(grads) if stacked else grads[0]
        dtype = g.dtype
        dims = factored_dims(shape, hp["factored"],
                             hp["min_dim_size_to_factor"])
        st = self.state[tensors[0]]
        if not st:
            self._init_state(st, g, dims, hp)
        decay = _decay_rate_pow(st["step"] - hp["decay_offset"],
                                hp["decay_rate"])
        # 1 - decay in fp32, as optax computes it from an fp32 array
        keep = float(np.float32(1.0) - np.float32(decay))
        st["step"] += 1

        # scale_by_factored_rms: the moments in fp32 against the decay,
        # stored in the leaf's dtype
        grad_sqr = g * g + hp["eps"]
        if dims is not None:
            d1, d0 = dims
            v_row = (st["v_row"].float() * decay
                     + grad_sqr.mean(d0).float() * keep).to(dtype)
            v_col = (st["v_col"].float() * decay
                     + grad_sqr.mean(d1).float() * keep).to(dtype)
            st["v_row"], st["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = (st["v"].float() * decay + grad_sqr.float() * keep).to(dtype)
            st["v"] = v
            u = g * v ** -0.5

        # clip_by_block_rms, scale_by_learning_rate and
        # scale_by_param_block_rms as one scalar, each factor rounded to
        # the leaf's dtype as optax's scalars of that dtype are
        scale = torch.ones((), dtype=dtype, device=g.device)
        if hp["clipping_threshold"] is not None:
            rms = _rms([torch.linalg.vector_norm(u, dtype=torch.float32)],
                       u.numel(), dtype)
            scale = scale / torch.clamp_min(
                rms / hp["clipping_threshold"], 1.0)
        if hp["learning_rate"] is not None:
            scale = scale * hp["learning_rate"]
        if hp["multiply_by_parameter_scale"]:
            prms = _rms(torch._foreach_norm(views, 2, dtype=torch.float32),
                        u.numel(), dtype)
            scale = scale * torch.where(prms <= 1e-3, 1e-3, prms).to(dtype)
        mask = hp["weight_decay_mask"]
        decay_w = hp["weight_decay_rate"] is not None and (
            mask is None or mask(name))
        if hp["momentum"] is None and not decay_w:
            # scale(-1) and apply_updates folded into one pass
            u = u * -scale
        else:
            u = u * scale
            if hp["momentum"] is not None:
                # optax's ema (debias=False): (1 - m) * u in u's dtype plus
                # m * ema in the accumulator's dtype
                m = hp["momentum"]
                u = u * (1.0 - m) + st["ema"] * m
                st["ema"] = u.to(hp["dtype_momentum"])
            if decay_w:
                p = torch.stack(views) if stacked else views[0]
                u = u + hp["weight_decay_rate"] * p
            u = -1 * u
        if u.dtype == dtype:
            torch._foreach_add_(views, list(u.unbind(0)) if stacked
                                else [u])
        else:
            # apply_updates: p + u in u's wider dtype, cast back
            for v, ui in zip(views, u.unbind(0) if stacked else [u]):
                v.copy_(v + ui)

    @staticmethod
    def _init_state(st, g, dims, hp):
        st["step"] = 0
        if dims is not None:
            d1, d0 = dims
            st["v_row"] = g.new_zeros([n for i, n in enumerate(g.shape)
                                       if i != d0])
            st["v_col"] = g.new_zeros([n for i, n in enumerate(g.shape)
                                       if i != d1])
        else:
            st["v"] = torch.zeros_like(g)
        if hp["momentum"] is not None:
            st["ema"] = torch.zeros(g.shape, dtype=hp["dtype_momentum"],
                                    device=g.device)


def _rms(norms, n, dtype):
    """sqrt(mean(x**2)) of a leaf from its parts' fp32 L2 norms, the mean
    rounded to the leaf's dtype as optax's mean of that dtype is."""
    sumsq = torch.stack(norms).square().sum()
    return (sumsq / n).to(dtype).sqrt()


def adafactor(learning_rate: Optional[float] = None,
              min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0,
              momentum: Optional[float] = None,
              dtype_momentum: torch.dtype = torch.float32,
              weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
              factored: bool = True,
              weight_decay_mask: Optional[Callable[[str], bool]] = None
              ) -> Callable[[Iterable], Adafactor]:
    """Counterpart of ``optax.adafactor``, with its signature and defaults:
    a factory that builds an ``Adafactor`` over parameters or param groups
    (``models.jax_leaf_groups``, as ``make_train_fns`` passes them).
    ``weight_decay_mask`` is a predicate over the JAX leaf's path
    (``group["name"]``), in place of optax's mask tree."""
    def make(params) -> Adafactor:
        return Adafactor(params, learning_rate, min_dim_size_to_factor,
                         decay_rate, decay_offset,
                         multiply_by_parameter_scale, clipping_threshold,
                         momentum, dtype_momentum, weight_decay_rate, eps,
                         factored, weight_decay_mask)
    return make
