from repro_torch.train.optimizer import (AdamWConfig, OptState, apply_updates,
                                         init_opt_state)
from repro_torch.train.train_step import (TrainState, compress_grads_int8,
                                          make_train_state, make_train_step,
                                          train_state_specs)

__all__ = ["AdamWConfig", "OptState", "apply_updates", "init_opt_state",
           "TrainState", "compress_grads_int8", "make_train_state",
           "make_train_step", "train_state_specs"]
