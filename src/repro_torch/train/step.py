"""train_step / eval_step factories: loss, grads, microbatching, QAT hook.

Port of ``repro.train.step``.  Every train step built here carries the
fused non-finite guard: one finiteness probe over loss + all grads
(``optimizer.nonfinite_probe``).  A non-finite step *skips* the update —
params and opt_state come back bit-identical (``tree_select`` copies the
old leaves; the step counter does not advance) — and reports
``metrics["skipped"] == 1`` so the loop (train/loop.py) can count skips
and escalate.  ``batch["loss_scale"]`` (an optional scalar tensor)
multiplies the loss *inside* the differentiated function: the
loss-scaling hook, and where train/faults.py poisons a step.

The steps are functional: a float leaf is differentiated through a
``detach().requires_grad_()`` view, so the caller's tensors are never
modified.  Integer leaves (PASM indices) get no gradient (``None`` in the
grads tree).  For bitwise reproducibility run them under
:func:`deterministic`.

Sharded, SPMD on a ``("data", "model")`` mesh (one process a rank): every
LM family's step under an active ``ShardCtx`` on params placed by
``models/sharding.py::place_params``, and the CNN QAT step with
``mesh=`` on a tree placed by ``cnn._place``.  Every rank passes the global
batch.  An LM rank keeps its own block of the logits (its rows, its vocab
columns where the head splits) and computes the global loss from it
(``api.sharded_lm_loss``: the log-softmax and the mean summed over the
axes), as JAX's step does on logits constrained to ``(batch, None,
model)``: no rank holds the global logits.  The backward runs through the
differentiable collectives, and between it and the update each gradient
leaf is summed over the axes ``grad_reduce_axes`` names, so a rank holds
the one-device gradient of its blocks.  The clip norm and the non-finite
guard are taken over the whole mesh; compressed gradients take each
leaf's global ``max |g|``; an optimizer state in JAX's ZeRO-1 layout
(``init_opt_state(mesh=)``) updates a rank's moment blocks.  At mesh
``(1, 1)`` the step is bitwise the unsharded one.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable

import torch

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.models.common import ShardCtx
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "make_eval_step", "make_cnn_train_step",
           "cnn_qat_loss", "cnn_loss_and_grads", "loss_and_grads", "deterministic"]


@contextlib.contextmanager
def deterministic():
    """Run the body under ``torch.use_deterministic_algorithms(True)``.

    Sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` first (unless the environment
    sets it), which cuBLAS needs to be deterministic; it takes effect for
    handles made after it, so enter this before the process's first cuBLAS
    call.  The previous mode is restored on exit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def _value_and_grad(loss_fn: Callable, params: Any) -> tuple:
    """``(loss, aux, grads)`` of ``loss_fn(params) -> (loss, aux)``; the
    grads tree has params' structure, ``None`` at integer leaves and zeros
    where a float leaf did not reach the loss."""
    diff = tree_map(lambda x: x.detach().requires_grad_() if x.is_floating_point()
                    else x, params)
    with torch.enable_grad():
        loss, aux = loss_fn(diff)
    leaves = tree_leaves(diff)
    wrt = [x for x in leaves if x.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for x in leaves:
        if not x.requires_grad:
            grads.append(None)
            continue
        g = next(got)
        grads.append(torch.zeros_like(x) if g is None else g)
    return loss.detach(), aux, tree_unflatten(diff, grads)


def _lm_loss(params, batch, cfg: ArchConfig, sctx: ShardCtx, model, scale=None):
    kw = {}
    if "frontend_embeds" in batch:
        kw["frontend_embeds"] = batch["frontend_embeds"]
    logits, aux = model.forward(params, batch["tokens"], cfg, sctx, logits_block=True, **kw)
    loss = api.sharded_lm_loss(logits, batch["labels"], batch.get("loss_mask"), cfg, sctx)
    if aux.get("moe_load_balance") is not None and cfg.moe:
        loss = loss + 0.01 * aux["moe_load_balance"] / max(cfg.n_layers, 1)
    if scale is not None:
        loss = loss * scale  # inside the grad: a poisoned scale poisons grads
    return loss, {k: v.detach() for k, v in aux.items()}


def _split_scale(batch: dict) -> tuple:
    """Pop the optional scalar ``loss_scale`` out of the batch (it must not
    ride the microbatch axis-0 slicing)."""
    if "loss_scale" not in batch:
        return batch, None
    return {k: v for k, v in batch.items() if k != "loss_scale"}, batch["loss_scale"]


def _check_sharded(sctx: ShardCtx, batch: dict, microbatches: int):
    """A microbatch's rows must split over ``data``."""
    rows = batch["tokens"].shape[0] // microbatches
    if sctx.batch_split and rows % sctx.dp:
        raise ValueError(f"a microbatch of {rows} rows does not split over the "
                         f"{sctx.dp} data ranks the context was built for")


def loss_and_grads(params, batch: dict, cfg: ArchConfig, sctx: ShardCtx = ShardCtx(),
                   *, microbatches: int = 1) -> tuple:
    """``(loss, aux, grads)`` of the LM loss — what :func:`make_train_step`
    hands the optimizer.  ``microbatches > 1`` accumulates gradients over
    sequential slices of the batch (activation-memory relief at a fixed
    global batch) and averages them.  Under an active ``sctx``
    ``params`` are a rank's placed blocks, every rank passes the global batch and gets the
    global loss from its own logits block, and each gradient leaf comes back summed over its
    ``grad_reduce_axes``: the one-device gradient of the rank's block."""
    if sctx.active:
        _check_sharded(sctx, batch, microbatches)
    loss, aux, grads = _accumulate(params, batch, cfg, sctx, microbatches)
    if sctx.active:
        from repro_torch.models import sharding as sh

        axes = sh.grad_reduce_axes(params, sctx.mesh, batch_split=sctx.batch_split)
        grads = sh.reduce_grads(grads, axes, sctx.mesh)
    return loss, aux, grads


def _accumulate(params, batch: dict, cfg: ArchConfig, sctx: ShardCtx,
                microbatches: int) -> tuple:
    model = api.get_model(cfg)
    batch, scale = _split_scale(batch)
    if microbatches == 1:
        return _value_and_grad(
            lambda p: _lm_loss(p, batch, cfg, sctx, model, scale), params)
    grads, loss = None, None
    for i in range(microbatches):
        mb = {k: v[i * (v.shape[0] // microbatches):(i + 1) * (v.shape[0] // microbatches)]
              for k, v in batch.items()}
        l, _, g = _value_and_grad(
            lambda p: _lm_loss(p, mb, cfg, sctx, model, scale), params)
        if grads is None:  # summed in f32 whatever the params' dtype, as JAX does
            grads = tree_map(lambda a: None if a is None else a.to(torch.float32), g)
        else:
            grads = tree_map(lambda a, b: None if a is None else a + b, grads, g)
        loss = l if loss is None else loss + l
    grads = tree_map(lambda g: None if g is None else g / microbatches, grads)
    return loss / microbatches, {}, grads


def _guarded_update(params, opt_state, loss, grads, ocfg, *, guard: bool,
                    mesh=None, block_axes=None, zero_dims=None):
    """AdamW + the fused non-finite guard: ONE probe scalar decides between
    the updated tree and the bit-identical old one (under ``mesh``, one
    probe for every rank, and the clip norm over the placement)."""
    new_p, new_s, metrics = opt.adamw_update(params, grads, opt_state, ocfg,
                                             mesh=mesh, block_axes=block_axes,
                                             zero_dims=zero_dims)
    if not guard:
        return new_p, new_s, dict(metrics, skipped=torch.zeros(
            (), dtype=torch.int32, device=loss.device))
    ok = opt.nonfinite_probe(loss, grads, mesh=mesh)
    params = opt.tree_select(ok, new_p, params)
    opt_state = opt.tree_select(ok, new_s, opt_state)
    return params, opt_state, dict(metrics, skipped=(~ok).to(torch.int32))


def make_train_step(
    cfg: ArchConfig,
    ocfg: opt.AdamWConfig,
    sctx: ShardCtx = ShardCtx(),
    *,
    microbatches: int = 1,
    compress_grads_bins: int = 0,
    guard_nonfinite: bool = True,
):
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``.

    ``compress_grads_bins`` applies the PASM-style dictionary compression
    to the gradients before the optimizer.  ``guard_nonfinite`` (default
    on) folds the fused non-finite guard into the step.  An active ``sctx``
    runs the step SPMD on placed params (:func:`loss_and_grads`), with the
    clip norm, the guard and each compressed leaf's ``max |g|`` over the
    whole mesh; an ``opt_state`` from ``init_opt_state(params, mesh=)``
    (JAX's ZeRO-1 moments) updates this rank's moment blocks.
    """
    mesh = sctx.mesh if sctx.active else None

    def train_step(params, opt_state, batch):
        with trace.span("train.step"):
            loss, aux, grads = loss_and_grads(params, batch, cfg, sctx,
                                              microbatches=microbatches)
            blocks = zdims = None
            if mesh is not None:
                from repro_torch.models import sharding as sh

                specs = sh.placed_specs(params, mesh)
                blocks = sh.block_axes(params, mesh, specs)
                if isinstance(opt_state, opt.ZeroOptState):
                    zdims = sh.zero_dims(params, mesh, specs)
            if compress_grads_bins:
                grads = opt.compress_grads(grads, compress_grads_bins, mesh=mesh,
                                           block_axes=blocks)
            params, opt_state, metrics = _guarded_update(
                params, opt_state, loss, grads, ocfg, guard=guard_nonfinite,
                mesh=mesh, block_axes=blocks, zero_dims=zdims)
        return params, opt_state, dict(metrics, loss=loss, **aux)

    return train_step


def make_eval_step(cfg: ArchConfig, sctx: ShardCtx = ShardCtx()):
    model = api.get_model(cfg)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, aux = _lm_loss(params, batch, cfg, sctx, model)
        return {"loss": loss, **aux}

    return eval_step


# ---------------------------------------------------------------------------
# CNN QAT: the AlexNet-family weight-shared training step
# ---------------------------------------------------------------------------


def cnn_qat_loss(tree: dict, batch: dict, cfg, *, mesh=None, scale=None):
    """Softmax cross-entropy through the STE-snapped conv stack.

    ``tree = {"params": cnn dense masters, "codebooks": [per-layer dicts]}``
    — both differentiable (``cnn.qat_forward``: masters get straight-through
    grads, codebook entries the bin-summed grads of their assigned weights).
    ``mesh=``: placed masters, the global images and labels on every rank,
    the global loss.
    """
    from repro_torch.models import cnn

    logits = cnn.qat_forward(tree["params"], tree["codebooks"], batch["images"],
                             cfg, mesh=mesh)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"][:, None].long())
    loss = torch.mean(nll)
    if scale is not None:
        loss = loss * scale
    return loss


def cnn_loss_and_grads(tree: dict, batch: dict, cfg, *, mesh=None, specs=None) -> tuple:
    """``(loss, grads)`` of :func:`cnn_qat_loss` — what
    :func:`make_cnn_train_step` hands the optimizer (``batch["loss_scale"]``
    honoured).  ``mesh=``: ``tree`` is placed (``cnn._place``) and each
    gradient leaf comes back summed over its axes (``data``; a layer's
    dictionary also over the ``model`` blocks that read it), the
    one-device gradient of the rank's blocks.  ``specs``: the tree's
    placement (default ``cnn.qat_specs(cfg, mesh)``)."""
    from repro_torch.models import cnn, sharding as sh

    batch, scale = _split_scale(batch)
    loss, _, grads = _value_and_grad(
        lambda t: (cnn_qat_loss(t, batch, cfg, mesh=mesh, scale=scale), {}), tree)
    if mesh is not None:
        specs = cnn.qat_specs(cfg, mesh) if specs is None else specs
        axes = sh.grad_reduce_axes(tree, mesh, specs, reads=cnn.qat_reads(cfg))
        grads = sh.reduce_grads(grads, axes, mesh)
    return loss, grads


def make_cnn_train_step(cfg, ocfg: opt.AdamWConfig, *, mesh=None,
                        guard_nonfinite: bool = True) -> Callable:
    """QAT train step for the conv stack: ``(tree, opt_state, batch) →
    (tree, opt_state, metrics)`` where ``tree`` holds the dense masters AND
    the per-layer codebooks (freeze with ``cnn.qat_requantize`` for
    serving).  The fused non-finite guard and ``batch["loss_scale"]``
    behave exactly as in :func:`make_train_step`.  ``mesh=`` runs the step
    SPMD on a tree placed by ``cnn._place`` (the masters' ``c_out`` blocks
    over ``model``, the codebooks whole): each rank computes its rows and
    blocks, then every gradient leaf is summed over its axes (``data``;
    a layer's dictionary also over the ``model`` blocks that read it) and
    the guard and the clip norm are taken over the mesh."""
    from repro_torch.models import cnn, sharding as sh

    specs = None if mesh is None else cnn.qat_specs(cfg, mesh)

    def train_step(tree, opt_state, batch):
        loss, grads = cnn_loss_and_grads(tree, batch, cfg, mesh=mesh, specs=specs)
        blocks = None if mesh is None else sh.block_axes(tree, mesh, specs)
        tree, opt_state, metrics = _guarded_update(
            tree, opt_state, loss, grads, ocfg, guard=guard_nonfinite, mesh=mesh,
            block_axes=blocks)
        return tree, opt_state, dict(metrics, loss=loss)

    return train_step
