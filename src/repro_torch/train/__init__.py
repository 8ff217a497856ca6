from .step import (TrainState, chunked_ce, make_grad_fn, make_loss_fn,
                   make_train_state, make_train_step)
from .trainer import Trainer
