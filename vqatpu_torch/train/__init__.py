"""Training (counterpart of ``vqatpu.train``): the train and eval steps and
the optimizer, exported here; the epoch loop (:mod:`vqatpu_torch.train.
loop`, ``train()``), checkpoints that either package resumes
(:mod:`vqatpu_torch.train.checkpoints`) and ``log.txt``'s logger
(:mod:`vqatpu_torch.train.logging`), which ``python -m
vqatpu_torch.cli.ffoe_train`` drives."""

from vqatpu_torch.train.optim import (Adamax, clip_flat_grads,
                                      global_grad_norm, lr_for_epoch)
from vqatpu_torch.train.steps import (TrainState, compute_score_mc,
                                      compute_score_with_logits,
                                      densify_target, make_eval_step,
                                      make_train_state, make_train_step,
                                      upcast_wire, wire_cast)

__all__ = ["Adamax", "TrainState", "clip_flat_grads", "compute_score_mc",
           "compute_score_with_logits", "densify_target", "global_grad_norm",
           "lr_for_epoch", "make_eval_step", "make_train_state",
           "make_train_step", "upcast_wire", "wire_cast"]
