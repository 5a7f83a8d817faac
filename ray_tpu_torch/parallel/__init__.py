from ray_tpu_torch.parallel.optim import adafactor, adamw
from ray_tpu_torch.parallel.train_step import (TrainState,
                                               chunked_cross_entropy,
                                               cross_entropy_loss,
                                               make_train_fns)

__all__ = ["TrainState", "adafactor", "adamw", "chunked_cross_entropy",
           "cross_entropy_loss", "make_train_fns"]
