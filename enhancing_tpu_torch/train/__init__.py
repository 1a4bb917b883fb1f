from .optim import (
    ExponentialDecayScheduler,
    LambdaWarmUpCosineScheduler,
    LambdaWarmUpLinearScheduler,
    make_ae_optimizer,
)
from .steps import GANTrainState, make_vitvq_eval_step, make_vitvq_train_step
from .trainer import Trainer

__all__ = [
    "ExponentialDecayScheduler", "LambdaWarmUpCosineScheduler",
    "LambdaWarmUpLinearScheduler", "make_ae_optimizer", "GANTrainState",
    "make_vitvq_eval_step", "make_vitvq_train_step", "Trainer",
]
