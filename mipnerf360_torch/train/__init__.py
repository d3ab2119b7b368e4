"""Training layer (counterpart of ``mipnerf360_tpu/train``): state,
schedule, the train step of both cadences and its K-step loops,
checkpoints, and the trainer."""
from .schedule import log_lerp_lr
from .state import TrainState, init_train_state, load_state_dict, state_dict
from .step import (joint_cadence_grads, joint_cadence_step,
                   make_banked_train_loop, make_train_loop, make_train_step,
                   reference_cadence_step)
