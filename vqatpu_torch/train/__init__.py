"""Training (counterpart of ``vqatpu.train``): the train and eval steps and
the optimizer.  The epoch loop, checkpoint saving and the training CLI
(``train/loop.py``, ``train/checkpoints.py``, ``cli/ffoe_train.py``) wait
for the data and eval port (ROADMAP queue A item 4)."""

from vqatpu_torch.train.optim import (Adamax, clip_flat_grads,
                                      global_grad_norm, lr_for_epoch)
from vqatpu_torch.train.steps import (TrainState, compute_score_with_logits,
                                      densify_target, make_eval_step,
                                      make_train_state, make_train_step,
                                      upcast_wire, wire_cast)

__all__ = ["Adamax", "TrainState", "clip_flat_grads",
           "compute_score_with_logits", "densify_target", "global_grad_norm",
           "lr_for_epoch", "make_eval_step", "make_train_state",
           "make_train_step", "upcast_wire", "wire_cast"]
