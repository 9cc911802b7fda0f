"""Training loop: LM training for the reasoner + PRM-head training.

Counterpart of ``repro.training.train_loop``. ``make_train_step`` builds
the (loss, grads, AdamW) step and ``make_prm_step`` the PRM head's; each
is a ``train_graph.TrainGraph``, the counterpart of the reference's
``jax.jit``: on the card one CUDA graph per batch signature (the first
call of a signature warms up eagerly, the second captures, every later
one replays), on the CPU the same body eagerly. A step makes the params
trainable while it takes their gradient (``trainable``:
``requires_grad`` set on the tree's leaves, cleared after, so the same
tensors serve an engine afterwards without recording a graph); the
gradients come from ``torch.autograd.grad`` over the leaves, and the
update writes them in place (on the card one launch of the fused AdamW
kernel a leaf). On the card the layers' attention is kernel K5 forward
and backward (``Model.forward`` recomputes each layer in the backward
pass, as the reference's ``jax.checkpoint`` does, so K5's forward runs
twice a step).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.prm import init_prm_head, reward_logit
from ..models import Model, cross_entropy_loss
from ..models.layers import apply_norm
from .optimizer import (AdamWConfig, replicated, adamw_update,
                        init_opt_state, tree_leaves)
from .train_graph import TrainGraph


@contextlib.contextmanager
def trainable(params):
    """Within the block every leaf of ``params`` requires grad (in place:
    the same tensors); yields the leaves in ``tree_leaves`` order."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield leaves
    finally:
        for p in leaves:
            p.requires_grad_(False)


def to_batch(arrays: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """numpy batch arrays -> tensors on ``device`` (token ids int64)."""
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.asarray(a))
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def lm_loss_fn(model: Model, params, batch) -> Tuple[torch.Tensor, Dict]:
    labels, mask = batch["labels"], batch["mask"]
    logits, aux = model.forward(params, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"))
    loss = cross_entropy_loss(logits, labels, mask)
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    loss_fn: Optional[Callable] = None) -> TrainGraph:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and state are updated in place, the metrics are
    the step's static 0-d tensors on the model's device (``loss``,
    ``aux_loss``, ``grad_norm``), overwritten by the next step of the same
    batch signature. The step is bound to the first call's trees."""
    return TrainGraph(train_body(model, opt_cfg, loss_fn), model.device)


def train_body(model: Model, opt_cfg: AdamWConfig,
               loss_fn: Optional[Callable] = None):
    """The train step's body, ``body(params, opt_state, batch) ->
    metrics`` (what ``make_train_step`` wraps in a ``TrainGraph``). With
    DTensor params the metrics come back replicated, as plain tensors."""
    loss_fn = loss_fn or lm_loss_fn

    def body(params, opt_state, batch):
        with trainable(params) as leaves:
            total, metrics = loss_fn(model, params, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        del total
        _, _, gnorm = adamw_update(opt_cfg, params,
                                   _like(params, iter(grads)), opt_state)
        metrics = {k: replicated(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return body


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    return {k: _like(tree[k], leaves) if isinstance(tree[k], dict)
            else next(leaves) for k in sorted(tree)}


def train_lm(model: Model, data_iter, steps: int,
             opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
             log_every: int = 50, params=None,
             logger: Optional[Callable] = None,
             step_fn: Optional[TrainGraph] = None):
    """Train the reasoner LM. Returns (params, history). ``step_fn`` (a
    fresh ``make_train_step`` of ``model`` and ``opt_cfg``, kept by the
    caller to read its graph's counters) is built here when None."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    if params is None:
        params = model.init_params(
            torch.Generator(model.device).manual_seed(seed))
    opt_state = init_opt_state(params)
    step_fn = step_fn or make_train_step(model, opt_cfg)
    history = []
    for i in range(steps):
        toks, labels, mask = next(data_iter)
        batch = to_batch({"tokens": toks, "labels": labels, "mask": mask},
                         model.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = i
            history.append(rec)
            if logger:
                logger(rec)
    return params, history


# ------------------------------------------------------------- PRM head


def hidden_states(model: Model, params, tokens) -> torch.Tensor:
    """Final-norm hidden states [B, S, D] (the decode path's PRM input)."""
    mc = model.cfg
    x = model._embed_inputs(params, tokens, None)
    b, s, _ = x.shape
    positions = model._positions(None, b, s, x.device)
    x, _ = model._run_layers(
        params, lambda lp, _, x: model._layer_train(lp, x, positions), x,
        None)
    return apply_norm(mc, params["final_norm"], x)


def make_prm_step(model: Model, lm_params, lr: float = 1e-2
                  ) -> TrainGraph:
    """The PRM head's step, ``step(head, None, batch) -> (head, None,
    {"prm_loss": ...})``: BCE on the frozen LM's hidden states, plain SGD
    on the head in place. The LM runs under ``torch.no_grad()``: on the
    card its attention is K5's forward alone."""

    def body(head, _, batch):
        with torch.no_grad():
            h = hidden_states(model, lm_params, batch["tokens"]).float()
        labels_t, mask_t = batch["labels"], batch["mask"]
        with trainable(head) as leaves:
            logit = reward_logit(head, h)
            bce = (torch.clamp(logit, min=0) - logit * labels_t
                   + torch.log1p(torch.exp(-logit.abs())))
            loss = (torch.sum(bce * mask_t)
                    / torch.clamp(mask_t.sum(), min=1.0))
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        return {"prm_loss": loss.detach()}

    return TrainGraph(body, model.device)


def train_prm_head(model: Model, lm_params, data_iter, steps: int,
                   lr: float = 1e-2, seed: int = 0,
                   logger: Optional[Callable] = None,
                   step_fn: Optional[TrainGraph] = None):
    """Fit the reward head on frozen LM hidden states (BCE, plain SGD)
    through ``make_prm_step`` (``step_fn``, built here when None)."""
    head = init_prm_head(torch.Generator(model.device).manual_seed(seed),
                         model.cfg.d_model, device=model.device)
    step_fn = step_fn or make_prm_step(model, lm_params, lr)
    history = []
    for i in range(steps):
        toks, labels, mask = next(data_iter)
        batch = to_batch({"tokens": toks, "labels": labels, "mask": mask},
                         model.device)
        head, _, out = step_fn(head, None, batch)
        if i % 50 == 0 or i == steps - 1:
            rec = {"step": i, "prm_loss": float(out["prm_loss"])}
            history.append(rec)
            if logger:
                logger(rec)
    return head, history
