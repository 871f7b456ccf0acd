"""Batch norm over the global batch of several processes: the train-mode
``ConvBN`` above one process (``models/common.py``).

JAX jits one program over the device mesh, and Flax's ``BatchNorm`` reduces
its statistics over the whole (sharded) batch. Here each process holds a
share of the batch, so the per-channel sums are all-reduced:

* forward: sum(x), sum(x²) and the count, in float32 (float64 for a
  float64 model) whatever the activation dtype; Flax 0.12's
  ``_compute_stats``: mean = E[x], var = max(E[x²] - E[x]², 0), the biased
  variance; y = (x - mean) * (weight / sqrt(var + eps)) + bias, computed in
  that dtype and rounded to the activation dtype;
* backward: sum(dy) and sum(dy * x_hat) over the global batch give
  dx = weight / sqrt(var + eps) * (dy - mean(dy) - x_hat * mean(dy * x_hat));
  the weight's and the bias's gradients are the rank's own sums, which DDP
  averages like every other parameter's.

Only ``torch.distributed.all_reduce`` is used, so it runs on gloo with CPU
or CUDA tensors and on NCCL. Every rank issues the same collectives in the
same order (its forward and its backward visit the same layers).
"""

from __future__ import annotations

import torch

from object_detectors_tpu_torch.parallel import mesh


def _channel_sums(*tensors: torch.Tensor) -> torch.Tensor:
    """Each [N, C, ...] tensor summed over every axis but the channel one,
    concatenated: [len(tensors) * C]."""
    return torch.cat([t.sum([d for d in range(t.dim()) if d != 1]) for t in tensors])


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class GlobalBatchNorm(torch.autograd.Function):
    """``apply(x, weight, bias, eps)`` -> (y, mean, var): ``y`` in x's dtype,
    the global batch's mean and biased variance (without gradient) for the
    running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dt = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        xs = x.to(dt)
        count = xs.new_tensor([x.numel() // c])
        sums = mesh.global_sum(torch.cat([_channel_sums(xs, xs * xs), count]))
        n = sums[-1]
        mean = sums[:c] / n
        var = (sums[c:2 * c] / n - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        mul = invstd * weight.to(dt)
        y = (xs - _per_channel(mean, x.dim())) * _per_channel(mul, x.dim()) \
            + _per_channel(bias.to(dt), x.dim())
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dt, c, nd = mean.dtype, x.shape[1], x.dim()
        dyf = dy.to(dt)
        xhat = (x.to(dt) - _per_channel(mean, nd)) * _per_channel(invstd, nd)
        local = _channel_sums(dyf, dyf * xhat)
        sums = mesh.global_sum(local)
        mean_dy, mean_dy_xhat = sums[:c] / n, sums[c:] / n
        dx = _per_channel(invstd * weight.to(dt), nd) * (
            dyf - _per_channel(mean_dy, nd) - xhat * _per_channel(mean_dy_xhat, nd))
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None)


def global_batch_norm(x: torch.Tensor, bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode batch norm of ``x`` [N, C, H, W] over the global batch
    with ``bn``'s weight, bias and eps; ``bn``'s running statistics move by
    0.1 toward the global mean and biased variance, as Flax's
    ``BatchNorm(momentum=0.9)`` and the one-process ``ConvBN`` move them."""
    y, mean, var = GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(mean.to(bn.running_mean.dtype), alpha=0.1)
        bn.running_var.mul_(0.9).add_(var.to(bn.running_var.dtype), alpha=0.1)
    return y
