"""Loss functions (port of the JAX package's ``ops/losses.py``): BCE and
softmax CE with logits, the focal family, the EQ loss, smooth-L1 / L1 / MSE
and the class-balanced weights of the effective number of samples.

Everything is elementwise and leaves the reduction to the caller ("none")
unless a ``reduction`` is given: the callers reduce with explicit masks
over padded, fixed-size tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_detectors_tpu_torch.parallel import mesh


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    """jax.nn.one_hot: [...] -> [..., num_classes]; a label outside
    [0, num_classes) gives a row of zeros."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).to(dtype)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 pos_weight: torch.Tensor | None = None) -> torch.Tensor:
    """BCE with logits (BCEWithLogitsLoss semantics, ``pos_weight`` scaling
    the positive term)."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is not None:
        return -(pos_weight * labels * log_p + (1.0 - labels) * log_not_p)
    return -(labels * log_p + (1.0 - labels) * log_not_p)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weight: torch.Tensor | None = None) -> torch.Tensor:
    """CE of logits [..., C] at integer labels [...] -> [...], scaled by
    ``weight[label]`` when a per-class weight [C] is given."""
    nll = -torch.log_softmax(logits, -1).gather(-1, labels[..., None].long())[..., 0]
    if weight is not None:
        nll = nll * weight[labels.long()]
    return nll


def weighted_ce_mean(logits, labels, weight, sample_mask=None):
    """CrossEntropyLoss(weight=w, reduction='mean'): sum(w[y] nll) / sum(w[y])
    over the unmasked samples; above one process the rank's share of that
    mean over the global batch (``parallel/mesh.py``)."""
    nll = softmax_cross_entropy(logits, labels, weight)
    w = weight[labels.long()] if weight is not None else torch.ones_like(nll)
    if sample_mask is not None:
        nll = nll * sample_mask
        w = w * sample_mask
    return mesh.rank_share(nll.sum() / mesh.global_sum(w.sum()).clamp(min=1e-12))


def focal_modulation(logits, labels, gamma: float, alpha: float):
    """The focal factor alpha_t * (1 - p_t) ** gamma."""
    p = torch.sigmoid(logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_factor = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma


def focal_loss(logits, labels, gamma: float = 1.5, alpha: float = 0.25,
               pos_weight: torch.Tensor | None = None, reduction: str = "none"):
    """The focal wrapper around BCE with logits."""
    loss = sigmoid_binary_cross_entropy(logits, labels, pos_weight)
    return _reduce(loss * focal_modulation(logits, labels, gamma, alpha), reduction)


def sigmoid_focal_loss(logits, labels, alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "none"):
    """torchvision's sigmoid_focal_loss: alpha < 0 turns the alpha factor
    off."""
    p = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, labels)
    p_t = p * labels + (1.0 - p) * (1.0 - labels)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * labels + (1.0 - alpha) * (1.0 - labels)) * loss
    return _reduce(loss, reduction)


def quality_focal_loss(logits, labels, gamma: float = 1.5, alpha: float = 0.25,
                       reduction: str = "none"):
    """Quality focal: BCE modulated by |y - p| ** gamma."""
    loss = sigmoid_binary_cross_entropy(logits, labels)
    p = torch.sigmoid(logits)
    alpha_factor = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    return _reduce(loss * alpha_factor * (labels - p).abs() ** gamma, reduction)


def bce_blur_with_logits(logits, labels, alpha: float = 0.05):
    """BCE with the missing-label effect reduced; elementwise."""
    loss = sigmoid_binary_cross_entropy(logits, labels)
    dx = torch.sigmoid(logits) - labels
    return loss * (1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4)))


def smooth_bce_targets(eps: float = 0.1):
    """(positive, negative) label-smoothing targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def eq_loss(logits, labels, rare_mask, gamma: float = 1.5, alpha: float = 0.25,
            pos_weight: torch.Tensor | None = None, reduction: str = "none"):
    """Equalization loss: the focal BCE of logits and labels [N, C], each
    element weighted by clip(rare_mask[c] + label, 0, 1), so positives always
    count and negatives only where ``rare_mask`` [C] is 1, as the reference
    computes it."""
    weights = (rare_mask[None, :] + labels).clamp(0.0, 1.0)
    loss = focal_loss(logits, labels, gamma, alpha, pos_weight, "none")
    return _reduce(loss * weights, reduction)


def smooth_l1_loss(pred, target, beta: float = 1.0, reduction: str = "none"):
    """smooth_l1_loss with ``beta`` (the RPN uses 1/9)."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    return _reduce(loss, reduction)


def l1_loss(pred, target, reduction: str = "none"):
    return _reduce((pred - target).abs(), reduction)


def mse_loss(pred, target, reduction: str = "none"):
    return _reduce((pred - target) ** 2, reduction)


def effective_number_weights(cls_num_list, beta: float = 0.9999) -> torch.Tensor:
    """Class-balanced weights of the effective number of samples:
    w_c = (1 - beta) / (1 - beta ** n_c), normalized to sum to C."""
    cls_num = torch.as_tensor(cls_num_list, dtype=torch.float32)
    w = (1.0 - beta) / (1.0 - torch.pow(beta, cls_num))
    return w / w.sum() * cls_num.shape[0]
