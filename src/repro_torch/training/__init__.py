"""Training substrate of the port: the synthetic corpus, AdamW, the train
step and loop, and checkpoints in the JAX package's file format."""

from .data import DataConfig, Syntheticcorpus, extra_inputs
from .optimizer import (AdamW, AdamWState, constant_schedule,
                        cosine_schedule, global_norm)
from .train import TrainResult, make_grad_accum_step, make_train_step, train
from . import checkpoint

__all__ = ["AdamW", "AdamWState", "DataConfig", "Syntheticcorpus",
           "TrainResult", "checkpoint", "constant_schedule",
           "cosine_schedule", "extra_inputs", "global_norm",
           "make_grad_accum_step", "make_train_step", "train"]
