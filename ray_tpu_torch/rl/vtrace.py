"""V-trace off-policy correction (IMPALA), PyTorch implementation.

Computes the v-trace value targets and policy-gradient advantages from
behavior-policy log-probs vs target-policy log-probs (reference:
rllib/algorithms/impala/vtrace_torch.py — re-derived from the IMPALA
paper's eq. 1). The JAX package runs the backward recursion as a
reversed ``lax.scan`` and stops the gradient at both outputs; here it is a
Python loop over T under ``torch.no_grad``, so the outputs carry no
gradient: a loss reaches the policy only through its own log-probs and
the baseline only through its own values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor              # [T, B] value targets for the baseline
    pg_advantages: torch.Tensor   # [T, B] advantages for the policy grad


@torch.no_grad()
def vtrace(behavior_logp: torch.Tensor,
           target_logp: torch.Tensor,
           rewards: torch.Tensor,
           discounts: torch.Tensor,
           values: torch.Tensor,
           bootstrap_value: torch.Tensor,
           clip_rho_threshold: float = 1.0,
           clip_c_threshold: float = 1.0) -> VTraceReturns:
    """All time-major [T, B]; bootstrap_value [B].

    discounts = gamma * (1 - done): zero at terminal steps.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=clip_c_threshold)

    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)

    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = []
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v.append(acc)
    vs = torch.stack(vs_minus_v[::-1]) + values

    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_advantages = clipped_rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
