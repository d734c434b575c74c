"""train_step factory: loss -> grads (accumulated over micro-batches) ->
clip -> AdamW.  Counterpart of ``repro.train.step``.

The model's forward launches the hand-written kernels on the card (their
autograd Functions carry the gradient through them); the step itself is
plain PyTorch.  The reference's mesh tooling (``opt_pspecs``,
``batch_pspecs``, ``assemble_train``, ``abstract_batch``) has no
one-card meaning and waits for the dry-run's port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import ref_leaves, ref_map
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_update, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    micro_batches: int = 1
    moments_dtype: str = "float32"     # "int8" => 8-bit optimizer states
    donate: bool = False               # signature parity only: no effect


def value_and_grad(cfg, model, batch):
    """-> (loss, grads shaped like ``param_tree(model)``).  A parameter
    that the loss does not reach gets a zero gradient of its own dtype, as
    JAX gives it (torch would give ``None``), so AdamW still moves its
    moments and decays it."""
    ptree = tfm.param_tree(model)
    leaves = ref_leaves(ptree)
    loss = tfm.train_loss(model, cfg, batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs))
    return loss.detach(), ref_map(lambda p: next(it), ptree)


def make_train_step(cfg, hp: TrainHParams):
    """Returns ``train_step(model, opt_state, batch) -> (loss, gnorm,
    model, opt_state)``.  ``batch`` holds tensors on the model's device.
    The model's parameters are overwritten with the updated ones (the
    reference returns new arrays; here the same model comes back), and the
    state is a new tree."""

    def train_step(model, opt_state, batch):
        if hp.micro_batches > 1:
            n = hp.micro_batches
            gsum = ref_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device),
                            tfm.param_tree(model))
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(cfg, model, mb)
                gsum = ref_map(torch.add, gsum, g)
                lsum = lsum + l
            grads = ref_map(lambda g: g / n, gsum)
            loss = lsum / n
        else:
            loss, grads = value_and_grad(cfg, model, batch)
        grads, gnorm = clip_by_global_norm(grads, hp.grad_clip)
        ptree = tfm.param_tree(model)
        new_p, opt_state = adamw_update(
            grads, opt_state, ptree, lr=hp.lr,
            weight_decay=hp.weight_decay, moments_dtype=hp.moments_dtype)
        with torch.no_grad():
            ref_map(lambda p, q: p.copy_(q), ptree, new_p)
        return loss, gnorm, model, opt_state

    return train_step
