"""Losses and the weight-decay mask (port of ``axcnn/train/losses.py``).

``softmax_ce_loss`` is the mixup-weighted, label-smoothed cross-entropy in
fp32. Weight decay applies to the leaves whose REFERENCE name starts with
``w``: conv and dense kernels ``w`` and the SE FCs ``w1``/``w2``; never BN
gamma/beta and never a bias. The mask is built from the reference's leaf
names through the converter's mapping, not from torch names: in the port a
BN scale and a conv kernel are both called ``weight``. ``kd_loss`` is the
knowledge-distillation term ``T^2 * KL(teacher_T || student_T)``.
"""

from __future__ import annotations

import torch

from axcnn_torch.ckpt.convert import reference_paths


def _smoothed_ce(log_probs, labels, label_smoothing: float):
    """CE against smoothed one-hot labels: ``(1-ls)*nll + ls*mean(-log p)``."""
    nll = -log_probs.gather(1, labels[:, None].long())[:, 0]
    uniform_term = -log_probs.mean(dim=1)
    return (1.0 - label_smoothing) * nll + label_smoothing * uniform_term


def softmax_ce_loss(logits, labels_a, labels_b=None, lam=1.0, *,
                    label_smoothing: float = 0.0):
    """Mean of ``lam * CE(labels_a) + (1 - lam) * CE(labels_b)``."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    loss = _smoothed_ce(log_probs, labels_a, label_smoothing)
    if labels_b is not None:
        loss_b = _smoothed_ce(log_probs, labels_b, label_smoothing)
        loss = lam * loss + (1.0 - lam) * loss_b
    return loss.mean()


def _is_decayed(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf.startswith("w")


def decay_mask(model: torch.nn.Module) -> dict:
    """``{parameter name: True where weight decay applies}``."""
    paths = reference_paths(model.state_dict())
    return {name: _is_decayed(paths[name]) for name, _ in model.named_parameters()}


def l2_regularization(model: torch.nn.Module, weight_decay: float):
    """``weight_decay * 0.5 * sum ||w||^2`` over the decayed parameters (the
    step adds ``weight_decay * w`` to the gradient instead, which is the
    same for momentum SGD)."""
    mask = decay_mask(model)
    total = sum(p.float().square().sum() for name, p in model.named_parameters()
                if mask[name])
    return weight_decay * 0.5 * total


def kd_loss(student_logits, teacher_logits, *, temperature: float = 1.0):
    """``T^2 * KL(teacher_T || student_T)``, the batch mean, in fp32 (the
    ``T^2`` keeps the gradient's scale independent of ``T``)."""
    t = temperature
    s = torch.log_softmax(student_logits.float() / t, dim=-1)
    p = torch.softmax(teacher_logits.float() / t, dim=-1)
    logp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = (p * (logp - s)).sum(dim=-1)
    return (t * t) * kl.mean()
