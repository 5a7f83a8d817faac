from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                           MedianStoppingRule,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.search import (choice, grid_search, loguniform,
                                       randint, uniform)
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig,
                                      Tuner, get_checkpoint, report)

__all__ = ["Tuner", "TuneConfig", "ResultGrid", "TrialResult", "report",
           "get_checkpoint", "grid_search", "choice", "uniform",
           "loguniform", "randint", "ASHAScheduler", "FIFOScheduler",
           "MedianStoppingRule", "PopulationBasedTraining"]
