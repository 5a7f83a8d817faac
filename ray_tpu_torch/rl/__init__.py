"""RL on the port (reference: rllib): PPO, APPO, IMPALA, DQN, SAC, BC,
multi-agent PPO and external-env PPO over gymnasium envs. Env runners are
CPU actors on the port's runtime; learners update on the card
(``AlgorithmConfig().learners(device=...)``, "cuda" by default).
gymnasium is imported where an env is built, so importing this package
needs none."""

from ray_tpu_torch.rl.actor_manager import (FaultTolerantRunnerSet,
                                            RunnerSetBroken)
from ray_tpu_torch.rl.algorithm import PPO, Algorithm
from ray_tpu_torch.rl.appo import APPO
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.dqn import DQN
from ray_tpu_torch.rl.external import (ExternalPPO, PolicyClient,
                                       PolicyServer)
from ray_tpu_torch.rl.impala import IMPALA
from ray_tpu_torch.rl.multi_agent import (MultiAgentConfig, MultiAgentEnv,
                                          MultiAgentEnvRunner, MultiAgentPPO)
from ray_tpu_torch.rl.offline import BC, BCConfig, record_experiences
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            ReplayBuffer, make_replay_buffer)
from ray_tpu_torch.rl.sac import SAC
from ray_tpu_torch.rl.vtrace import vtrace

__all__ = ["Algorithm", "PPO", "APPO", "IMPALA", "DQN", "SAC",
           "ExternalPPO", "PolicyClient", "PolicyServer",
           "AlgorithmConfig", "ReplayBuffer", "PrioritizedReplayBuffer",
           "make_replay_buffer", "vtrace", "MultiAgentEnv",
           "MultiAgentConfig", "MultiAgentEnvRunner", "MultiAgentPPO",
           "BC", "BCConfig", "record_experiences",
           "FaultTolerantRunnerSet", "RunnerSetBroken"]
