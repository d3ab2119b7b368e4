"""Training layer (counterpart of ``mipnerf360_tpu/train``): state,
schedule, the train step of both cadences. The train loops, checkpoints and
the trainer are not ported yet."""
from .schedule import log_lerp_lr
from .state import TrainState, init_train_state
from .step import (joint_cadence_grads, joint_cadence_step, make_train_step,
                   reference_cadence_step)
