"""The training step and loop (port of ``repro.train``)."""
from .trainer import (TrainLoopConfig, make_eval_step, make_sig_mmd_loss,
                      make_train_step, place_batch, replicate_tree,
                      train_loop)

__all__ = ["TrainLoopConfig", "make_eval_step", "make_sig_mmd_loss",
           "make_train_step", "place_batch", "replicate_tree", "train_loop"]
