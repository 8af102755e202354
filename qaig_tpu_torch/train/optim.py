"""Optimizer factory (counterpart of ``qaig_tpu/train/optim.py``).

Adam with betas (0.5, 0.999) and eps 1e-8, and the step-count learning-rate
halving of the reference training loops: update ``c`` (0-based) runs at
``lr0 * 0.5**(max(c-1, 0) // lr_step)``.  The JAX package folds the
halving into an optax schedule read at the update's count; here it is a
``LambdaLR`` stepped once after each update, which reads the same factor
at the same count.

On CUDA the Adam is ``capturable`` and each group's learning rate is a
0-d tensor on the card, so that a train step captured as a CUDA graph
reads the current rate at every replay: the schedule (``LambdaLR``, which
fills a tensor rate in place, and :func:`set_update_count`) writes into
that tensor and never replaces it.  A capturable Adam computes its bias
correction on the device, which can round differently in the last bit
from the CPU's host-side one.
"""

import torch


def halving_factor(lr_step):
    """The schedule's multiplier at update count ``c``."""
    def factor(count):
        return 0.5 ** (max(count - 1, 0) // lr_step)
    return factor


def make_adam(params, base_lr, lr_step=None, capturable=None):
    """Adam(0.5, 0.999) over ``params`` and its halving schedule (None
    without ``lr_step``).  Step the schedule after every update.
    ``capturable`` (None: the parameters lie on CUDA) makes the Adam
    capturable, with the learning rate as a tensor on the parameters'
    device."""
    params = list(params)
    if capturable is None:
        capturable = params[0].device.type == "cuda"
    optimizer = torch.optim.Adam(params, lr=base_lr, betas=(0.5, 0.999),
                                 eps=1e-8, capturable=capturable)
    scheduler = (torch.optim.lr_scheduler.LambdaLR(
        optimizer, halving_factor(lr_step)) if lr_step else None)
    if capturable:
        # after the schedule took its base rates as floats, so that it
        # fills the tensor from the host without reading the device
        for group in optimizer.param_groups:
            group["lr"] = torch.tensor(float(group["lr"]),
                                       device=params[0].device)
    return optimizer, scheduler


def set_update_count(optimizer, scheduler, count):
    """Put the schedule at update ``count`` (a resumed run's next update),
    as optax's ``ScaleByScheduleState(count)`` does: into a group's
    learning-rate tensor when it has one."""
    if scheduler is None:
        return
    scheduler.last_epoch = count
    for group, base_lr, factor in zip(optimizer.param_groups,
                                      scheduler.base_lrs,
                                      scheduler.lr_lambdas):
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(base_lr * factor(count))
        else:
            group["lr"] = base_lr * factor(count)


def init_adam_state(optimizer):
    """Create a ``torch.optim.Adam``'s per-parameter state (step 0, zero
    moments) where it has none, as its first ``step()`` would; a step
    captured in a CUDA graph must find it (a capture would record its
    creation, which every replay would then redo)."""
    if not isinstance(optimizer, torch.optim.Adam):
        return
    from qaig_tpu_torch.convert import adam_entry
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not optimizer.state.get(p):
                optimizer.state[p] = adam_entry(
                    optimizer, p, 0, torch.zeros_like(p),
                    torch.zeros_like(p))


def current_lr(base_lr, lr_step, count):
    """Host-side mirror of the schedule (for log lines)."""
    if not lr_step:
        return base_lr
    return base_lr * halving_factor(lr_step)(count)
