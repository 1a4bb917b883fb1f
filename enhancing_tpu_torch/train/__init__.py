from .optim import (
    ExponentialDecayScheduler,
    LambdaWarmUpCosineScheduler,
    LambdaWarmUpLinearScheduler,
    MultiSteps,
    gpt_decay_mask,
    make_ae_optimizer,
    make_gpt_optimizer,
)
from .steps import (GANTrainState, TrainState,
                    make_cond_transformer_eval_step,
                    make_cond_transformer_train_step, make_vitvq_eval_step,
                    make_vitvq_train_step, make_vitvq_train_steps_split,
                    split_key)
from .trainer import Trainer

__all__ = [
    "ExponentialDecayScheduler", "LambdaWarmUpCosineScheduler",
    "LambdaWarmUpLinearScheduler", "MultiSteps", "gpt_decay_mask",
    "make_ae_optimizer",
    "make_gpt_optimizer", "GANTrainState", "TrainState",
    "make_cond_transformer_eval_step", "make_cond_transformer_train_step",
    "make_vitvq_eval_step", "make_vitvq_train_step",
    "make_vitvq_train_steps_split", "split_key", "Trainer",
]
