"""Optimizer factory (counterpart of ``qaig_tpu/train/optim.py``).

Adam with betas (0.5, 0.999) and eps 1e-8, and the step-count learning-rate
halving of the reference training loops: update ``c`` (0-based) runs at
``lr0 * 0.5**(max(c-1, 0) // lr_step)``.  The JAX package folds the
halving into an optax schedule read at the update's count; here it is a
``LambdaLR`` stepped once after each update, which reads the same factor
at the same count.
"""

import torch


def halving_factor(lr_step):
    """The schedule's multiplier at update count ``c``."""
    def factor(count):
        return 0.5 ** (max(count - 1, 0) // lr_step)
    return factor


def make_adam(params, base_lr, lr_step=None):
    """Adam(0.5, 0.999) over ``params`` and its halving schedule (None
    without ``lr_step``).  Step the schedule after every update."""
    optimizer = torch.optim.Adam(params, lr=base_lr, betas=(0.5, 0.999),
                                 eps=1e-8)
    scheduler = (torch.optim.lr_scheduler.LambdaLR(
        optimizer, halving_factor(lr_step)) if lr_step else None)
    return optimizer, scheduler


def set_update_count(optimizer, scheduler, count):
    """Put the schedule at update ``count`` (a resumed run's next update),
    as optax's ``ScaleByScheduleState(count)`` does."""
    if scheduler is None:
        return
    scheduler.last_epoch = count
    for group, base_lr, factor in zip(optimizer.param_groups,
                                      scheduler.base_lrs,
                                      scheduler.lr_lambdas):
        group["lr"] = base_lr * factor(count)


def current_lr(base_lr, lr_step, count):
    """Host-side mirror of the schedule (for log lines)."""
    if not lr_step:
        return base_lr
    return base_lr * halving_factor(lr_step)(count)
