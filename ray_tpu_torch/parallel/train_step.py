"""The training step, on one device or over a device mesh.

Counterpart of ``ray_tpu/parallel/train_step.py`` (``make_train_fns``,
``make_infer_fns``, ``state_shardings``, ``cross_entropy_loss``,
``chunked_cross_entropy``). A step runs the model's forward under autograd
(attention through the flash kernels' ``torch.autograd.Function``: the
forward kernel, then the dQ and dK/dV kernels in the backward), the loss,
``backward``, the global norm of the gradients and the optimizer's update.
Parameters are stored in ``cfg.param_dtype`` and cast to ``cfg.dtype`` at
each use, so their gradients arrive in the parameters' dtype, as JAX's AD
returns them: fp32 master weights by default, or bf16 weights and
gradients with ``param_dtype=torch.bfloat16`` (the JAX bench's recipe);
RMSNorm scales stay fp32 in both. Each block runs under activation
recompute as ``cfg.remat``/``cfg.remat_policy`` say. For an expert model
(``cfg.n_experts > 0``) the loss differentiated is the cross-entropy plus
``cfg.router_aux_coef`` times the expert layers' load-balancing loss, as
in the JAX step. The optimizer is built over one param group per JAX leaf
(``models.jax_leaf_groups``), which optax's per-leaf rules
(``parallel.optim.adafactor``) need.

With a ``mesh`` (``parallel.mesh.make_mesh``) every parameter is a DTensor
placed as ``state_shardings`` says (the JAX rule table applied to each
parameter's logical axes, ``models/axes.py``), the batch is sharded over
(data, fsdp) x seq, and DTensor's ops insert the collectives; attention
runs as a ``local_map`` island (``ops/dispatch.py``). Each gradient is
pinned to its parameter's placements before the norm and the update (the
reduction over the data axes that DTensor leaves pending). A mesh of one
rank takes the same path. With a ``profiler`` (``util/profiling.
StepProfiler``) each step is attributed compute vs host gap and its FLOPs
counted once per input shape (``StepProfiler.wrap_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.axes import param_axes
from ray_tpu_torch.models.convert import init_params, jax_leaf_groups
from ray_tpu_torch.models.transformer import TransformerLM
from ray_tpu_torch.parallel import sharding as sharding_lib
from ray_tpu_torch.parallel.sharding import (_prune_indivisible,
                                             distribute_whole, gather_whole,
                                             load_whole, on_mesh,
                                             spec_to_placements)


@dataclasses.dataclass
class TrainState:
    """Counterpart of the JAX ``TrainState``: the step count, and the model
    and optimizer, which hold the parameters and the optimizer's state and
    are updated in place."""
    step: int
    model: TransformerLM
    optimizer: torch.optim.Optimizer


def _nll(logits, targets):
    """Per-position negative log-likelihood: logsumexp in fp32 over the
    logits (bf16 or fp32), the gold logit gathered in the logits' dtype and
    then upcast, as JAX does. The gathered dim is dropped only after the
    subtraction: on vocab-sharded DTensor logits the gather is a masked
    partial sum, whose mask has the gather's [..., 1] shape."""
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = logits.gather(-1, targets[..., None]).float()
    return (logz[..., None] - gold)[..., 0]


def cross_entropy_loss(logits, targets, mask=None):
    """Mean cross-entropy of logits [B,L,V] against targets [B,L] over the
    positions ``mask`` keeps. Returns (loss, denom): denom is the number of
    positions (no mask) or max(mask.sum(), 1)."""
    nll = _nll(logits, targets)
    if mask is None:
        return nll.mean(), nll.numel()
    mask = mask.float()
    denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom, denom


def _chunk_nll_sum(h, unembed, targets, mask):
    return (_nll(h @ unembed, targets) * mask).sum()


def chunked_cross_entropy(h, unembed, targets, mask=None, chunk=256):
    """Cross-entropy over sequence chunks: the logits of one [B,chunk,V]
    block at a time, each chunk's body under activation checkpointing, so
    the backward recomputes the block's unembed product instead of keeping
    its logits and the [B,L,V] logits never exist (JAX's
    ``jax.checkpoint(nothing_saveable)`` scan body).

    h [B,L,d] final hidden states; unembed [d,V]. An L that is not a
    multiple of the chunk is padded and the pad masked. Returns
    (loss, denom) with denom = max(mask.sum(), 1)."""
    # pin h to the canonical activation layout at this boundary, as the
    # JAX step does
    h = sharding_lib.constrain(h, ("batch", "seq", None))
    B, L, _ = h.shape
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        keep = (torch.arange(L + pad, device=h.device) < L).expand(B, -1)
        if mask is not None:
            mask = torch.cat([mask.bool(), mask.new_zeros(
                (B, pad), dtype=torch.bool)], dim=1) & keep
        else:
            mask = keep
    m = (torch.ones(targets.shape, device=h.device) if mask is None
         else mask.float())
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, L + pad, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, h[:, i:i + chunk], unembed,
            targets[:, i:i + chunk], m[:, i:i + chunk], use_reentrant=False)
    denom = m.sum().clamp_min(1.0)
    return total / denom, denom


def _translate_entry(entry, rules):
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        out = []
        for e in entry:
            m = rules.get(e)
            if m is None:
                continue
            if isinstance(m, (tuple, list)):
                out.extend(m)
            else:
                out.append(m)
        return tuple(out) if out else None
    m = rules.get(entry)
    return tuple(m) if isinstance(m, list) else m


def logical_pspec_to_mesh(spec, rules) -> tuple:
    """A spec of logical names (an entry may be a tuple of them) -> mesh
    spec, each mesh axis used at most once."""
    if not isinstance(spec, tuple):
        return ()
    used = set()
    out = []
    for entry in spec:
        m = _translate_entry(entry, rules)
        if m is not None:
            key = m if isinstance(m, tuple) else (m,)
            if any(a in used for a in key):
                m = None
            else:
                used.update(key)
        out.append(m)
    return tuple(out)


def _port_spec(jax_spec: tuple, info) -> tuple:
    """The JAX leaf's mesh spec -> the spec of one port tensor of the leaf:
    the stacked layers' axis dropped, and flattened dims merged (the
    leading one of a merged group may be sharded, which keeps whole heads
    on a shard; a later one may not)."""
    per_layer = jax_spec[1:] if info.stacked else jax_spec
    if info.stacked and jax_spec[0] is not None:
        raise ValueError(f"{info.leaf}: the layers axis is sharded "
                         f"({jax_spec[0]!r}); the port keeps one tensor per "
                         f"layer and cannot")
    out = []
    for dims in info.port_dims:
        if any(per_layer[d] is not None for d in dims[1:]):
            raise ValueError(f"{info.leaf}: spec {jax_spec} shards a dim "
                             f"that the port flattens behind another")
        out.append(per_layer[dims[0]])
    return tuple(out)


def state_shardings(model: TransformerLM, mesh: DeviceMesh, rules=None
                    ) -> Dict[str, Tuple[tuple, tuple]]:
    """{parameter name: (DTensor placements, JAX spec)}: the JAX spec is the
    mesh spec that the JAX ``state_shardings`` gives the parameter's leaf
    (logical axes through the rules, a dim that does not divide by its
    mesh axes replicated, decided on the JAX leaf's shape), and the
    placements carry it onto the port tensor's dims. ``mesh`` may be a
    resolved ``MeshConfig`` in place of the mesh it describes."""
    rules = rules or sharding_lib.DEFAULT_RULES
    out = {}
    for name, info in param_axes(model.cfg).items():
        jax_spec = _prune_indivisible(
            logical_pspec_to_mesh(info.axes, rules), info.shape, mesh)
        out[name] = (spec_to_placements(_port_spec(jax_spec, info), mesh),
                     jax_spec)
    return out


def _batch_placements(mesh, rules, shape, logical=("batch", "seq")):
    """Placements of a batch-like tensor of ``shape`` (a dim that does not
    divide by its mesh axes replicated, as the JAX step's batch)."""
    spec = _prune_indivisible(logical_pspec_to_mesh(logical, rules), shape,
                              mesh)
    return spec_to_placements(spec, mesh)


@torch.no_grad()
def load_params(model: TransformerLM, state_dict) -> None:
    """Copy whole tensors (the same on every rank, e.g. from
    ``convert.params_from_jax``) into the model's parameters in place,
    each into its own shards where the parameter is a DTensor, so an
    optimizer built over the parameters keeps them."""
    for name, p in model.named_parameters():
        full = torch.as_tensor(state_dict[name]).to(p.device, p.dtype)
        if isinstance(p, DTensor):
            full = distribute_whole(full, p.device_mesh, p.placements)
        p.copy_(full)


def make_train_fns(model: TransformerLM,
                   optimizer: Callable[..., torch.optim.Optimizer],
                   mesh: Optional[DeviceMesh] = None, rules=None,
                   batch_shape: Tuple[int, int] = (8, 512),
                   loss_chunk: Optional[int] = None, device="cuda",
                   profiler=None
                   ) -> Tuple[Callable, Callable, Optional[dict]]:
    """Returns (init_fn(generator) -> TrainState, step_fn(state, tokens,
    mask=None) -> (state, metrics), shardings): ``shardings`` is
    ``state_shardings(model, mesh, rules)``, or None without a mesh.

    ``optimizer`` is a factory over param groups (``parallel.optim.adamw``,
    ``parallel.optim.adafactor``). ``init_fn`` fills the model with seeded
    random weights in ``cfg.param_dtype`` (``convert.init_params``; norm
    scales in fp32) on ``device``, distributed over the mesh when there is
    one (every rank makes the whole tensors from the same seed and keeps
    its shards, so the weights are the same under every layout), and
    builds the optimizer over its JAX-leaf param groups; a model loaded
    another way can be loaded after it (``load_state_dict`` copies into
    the same parameters). ``step_fn`` takes tokens of ``batch_shape``
    [B, L+1], the same on every rank: inputs are ``tokens[:, :-1]``,
    targets ``tokens[:, 1:]``, the loss mask ``mask[:, 1:]``. It updates
    the model and optimizer in place, advances ``state.step``, and returns
    the metrics ``loss`` (cross-entropy), ``total_loss`` (what was
    differentiated: for an expert model ``loss + cfg.router_aux_coef *
    moe_aux``, else ``loss``), ``moe_aux`` (the expert layers' summed
    load-balancing loss, 0 for a dense model), ``grad_norm`` (global L2
    norm of the gradients before the update) and ``tokens`` (the loss's
    denominator), as whole tensors on every rank. ``loss_chunk`` turns on
    ``chunked_cross_entropy``.

    profiler: an optional ``util.profiling.StepProfiler``; each call of
    the returned step_fn then runs in ``profiler.step(tokens=B*(L+1))``
    (the tokens it was given, as JAX counts them), its FLOPs counted on
    the first call of each shape (``profiler.wrap_step``), and blocks on
    the loss before the step ends, which sets the
    ``runtime_<name>_mfu`` gauges and records a ``<name>.step`` span."""
    dev = resolve_device(device)
    cfg = model.cfg
    shardings = (state_shardings(model, mesh, rules) if mesh is not None
                 else None)
    rules = rules or sharding_lib.DEFAULT_RULES

    def init_fn(generator: torch.Generator) -> TrainState:
        load_whole(model,
                   init_params(cfg, generator, dev, dtype=cfg.param_dtype),
                   mesh, shardings)
        return TrainState(step=0, model=model,
                          optimizer=optimizer(jax_leaf_groups(model)))

    def loss_fn(tokens, mask):
        """-> (cross-entropy, its denominator, the MoE aux loss)."""
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        tgt_mask = None if mask is None else mask[:, 1:]
        out, aux = model(inputs, return_hidden=bool(loss_chunk),
                         return_aux=True)
        if loss_chunk:
            ce, denom = chunked_cross_entropy(
                out, model.unembed_weight(), targets, tgt_mask,
                chunk=loss_chunk)
        else:
            ce, denom = cross_entropy_loss(out, targets, tgt_mask)
        return ce, denom, aux

    def step_fn(state: TrainState, tokens, mask=None):
        tokens = torch.as_tensor(tokens, device=dev)
        if tuple(tokens.shape) != tuple(batch_shape):
            raise ValueError(f"tokens {tuple(tokens.shape)}; this step "
                             f"takes {tuple(batch_shape)}")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        state.optimizer.zero_grad(set_to_none=True)
        with on_mesh(mesh):
            if mesh is not None:
                place = _batch_placements(mesh, rules, tuple(batch_shape))
                tokens = distribute_whole(tokens, mesh, place)
                if mask is not None:
                    mask = distribute_whole(mask, mesh, place)
            ce, denom, aux = loss_fn(tokens, mask)
            loss = (ce + cfg.router_aux_coef * aux if cfg.n_experts > 0
                    else ce)
            # a loss left partial over the batch's ranks is reduced before
            # the backward seeds it
            gather_whole(loss).backward()
            grads = []
            for p in state.model.parameters():
                if p.grad is None:
                    continue
                if isinstance(p.grad, DTensor) and \
                        p.grad.placements != p.placements:
                    # pin the gradient to its parameter's placements: the
                    # reduction over the data axes DTensor leaves pending
                    p.grad = p.grad.redistribute(p.device_mesh,
                                                 p.placements)
                grads.append(p.grad)
            gnorm = gather_whole(torch.nn.utils.get_total_norm(grads))
            state.optimizer.step()
        state.step += 1
        return state, {"loss": gather_whole(ce).detach(),
                       "total_loss": gather_whole(loss).detach(),
                       "moe_aux": gather_whole(aux).detach(),
                       "grad_norm": gnorm,
                       "tokens": gather_whole(denom)}

    if profiler is None:
        return init_fn, step_fn, shardings
    profiled_step = profiler.wrap_step(step_fn)

    def step_with_profile(state: TrainState, tokens, mask=None):
        with profiler.step(tokens=int(torch.as_tensor(tokens).numel())) \
                as sc:
            sc.data_ready()
            out = profiled_step(state, tokens, mask)
            sc.block(out[1]["loss"])
        return out

    return init_fn, step_with_profile, shardings


def make_infer_fns(model: TransformerLM, mesh: DeviceMesh, rules=None,
                   batch_shape: Tuple[int, int] = (8, 128), device="cuda"
                   ) -> Tuple[Callable, Callable, dict]:
    """Serving-side counterpart of ``make_train_fns``: (init_fn(generator)
    -> model, infer_fn(tokens) -> last-position logits [B, V], shardings).
    The parameters shard per ``state_shardings`` (stored in ``cfg.dtype``,
    the serving storage), the batch over the data axes, and the logits
    come back whole on every rank. Only the last position is projected
    onto the vocabulary: [B, d] x [d, V], not [B, L, V]."""
    dev = resolve_device(device)
    cfg = model.cfg
    shardings = state_shardings(model, mesh, rules)
    rules = rules or sharding_lib.DEFAULT_RULES

    def init_fn(generator: torch.Generator) -> TransformerLM:
        load_whole(model, init_params(cfg, generator, dev), mesh, shardings)
        return model

    @torch.no_grad()   # not inference_mode: see sharding.constrain
    def infer_fn(tokens):
        tokens = torch.as_tensor(tokens, device=dev)
        if tuple(tokens.shape) != tuple(batch_shape):
            raise ValueError(f"tokens {tuple(tokens.shape)}; this function "
                             f"takes {tuple(batch_shape)}")
        with on_mesh(mesh):
            tokens = distribute_whole(tokens, mesh, _batch_placements(
                mesh, rules, tuple(batch_shape)))
            h = model(tokens, return_hidden=True)
            logits = h[:, -1, :] @ model.unembed_weight()
            return gather_whole(logits)

    return init_fn, infer_fn, shardings
