"""External-env plane: policy server + client (reference:
rllib/env/policy_server_input.py + policy_client.py — simulators the
framework does NOT manage connect over HTTP, ask the current policy for
actions, report rewards, and their experience trains the learner).

Shape: a PolicyServer actor hosts the policy module and a threaded HTTP
endpoint. Each get_action runs the module forward (recording logp +
value for the eventual PPO loss); episode ends compute GAE server-side
— the server plays the env-runner's role for envs it cannot step.
ExternalPPO swaps env runners for policy servers in the standard
sample → learn → sync-weights loop. External sims keep working across
weight syncs (actions just start coming from the newer policy). The
server's policy runs on the CPU, as an env runner's does
(rl/env_runner.py says why); ExternalPPO's learner group updates on the
config's ``learner_device``."""

from __future__ import annotations

import json
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np


class PolicyServer:
    """Actor: HTTP policy endpoint + experience buffer.

    Routes (POST, JSON bodies):
      /start_episode  {}                          -> {episode_id}
      /get_action     {episode_id, observation}   -> {action}
      /log_returns    {episode_id, reward}        -> {}
      /end_episode    {episode_id, observation}   -> {}
    """

    def __init__(self, config: Dict, port: int = 0):
        import http.server

        import torch

        from ray_tpu_torch.rl.rl_module import make_rl_module
        self.cfg = config
        obs_shape = tuple(config["obs_shape"])
        self.module = make_rl_module(
            obs_shape, config["action_spec"],
            config.get("hidden_sizes", (64, 64)),
            seed=config.get("seed", 0), device="cpu")
        self._rng = torch.Generator().manual_seed(config.get("seed", 0) + 31)
        self.gamma = config.get("gamma", 0.99)
        self.lam = config.get("lambda_", 0.95)
        self._lock = threading.Lock()
        # episode_id -> {"obs": [...], "actions": [...], "logp": [...],
        #               "values": [...], "rewards": [...]}
        self._episodes: Dict[str, Dict[str, List]] = {}
        self._complete: List[Dict[str, np.ndarray]] = []   # GAE'd fragments
        self._returns: List[float] = []

        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                try:
                    out = server._route(self.path, body)
                    data = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:   # surfaced to the client
                    data = json.dumps({"error": f"{type(e).__name__}: "
                                                f"{e}"}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        self._http = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                     _Handler)
        threading.Thread(target=self._http.serve_forever,
                         daemon=True).start()

    # ------------------------------------------------------------ routes
    def _route(self, path: str, body: Dict) -> Dict:
        if path == "/start_episode":
            eid = body.get("episode_id") or uuid.uuid4().hex[:12]
            with self._lock:
                self._episodes[eid] = {"obs": [], "actions": [],
                                       "logp": [], "values": [],
                                       "rewards": []}
            return {"episode_id": eid}
        if path == "/get_action":
            return {"action": self._get_action(
                body["episode_id"], np.asarray(body["observation"],
                                               np.float32))}
        if path == "/log_returns":
            with self._lock:
                ep = self._episodes[body["episode_id"]]
                ep["rewards"].append(float(body["reward"]))
            return {}
        if path == "/end_episode":
            self._end_episode(body["episode_id"],
                              np.asarray(body["observation"], np.float32))
            return {}
        raise ValueError(f"unknown route {path}")

    def _get_action(self, eid: str, obs: np.ndarray):
        with self._lock:
            action, logp, value = self.module.sample_actions(obs[None],
                                                             self._rng)
            ep = self._episodes[eid]
            if len(ep["rewards"]) < len(ep["actions"]):
                # client skipped log_returns for a step: implicit 0
                ep["rewards"].append(0.0)
            ep["obs"].append(obs)
            ep["actions"].append(np.asarray(action)[0])
            ep["logp"].append(float(logp[0]))
            ep["values"].append(float(value[0]))
        act = np.asarray(action)[0]
        return act.item() if act.shape == () else act.tolist()

    def _end_episode(self, eid: str, final_obs: np.ndarray):
        """Close the episode and GAE it into a training fragment (the
        env-runner's fragment-end role; terminal value = 0 — external
        episodes end on real termination)."""
        with self._lock:
            ep = self._episodes.pop(eid)
            T = len(ep["actions"])
            if T == 0:
                return
            while len(ep["rewards"]) < T:
                ep["rewards"].append(0.0)
            rew = np.asarray(ep["rewards"], np.float32)
            val = np.asarray(ep["values"], np.float32)
            adv = np.zeros(T, np.float32)
            lastgaelam = 0.0
            for t in reversed(range(T)):
                next_value = val[t + 1] if t + 1 < T else 0.0
                delta = rew[t] + self.gamma * next_value - val[t]
                lastgaelam = delta + self.gamma * self.lam * lastgaelam
                adv[t] = lastgaelam
            self._complete.append({
                "obs": np.stack(ep["obs"]).astype(np.float32),
                "actions": np.asarray(ep["actions"]),
                "logp": np.asarray(ep["logp"], np.float32),
                "advantages": adv,
                "value_targets": adv + val,
            })
            self._returns.append(float(rew.sum()))

    # ------------------------------------------------------- trainer side
    def address(self) -> str:
        from ray_tpu_torch._private.rpc import node_ip_address
        return f"http://{node_ip_address()}:{self._http.server_port}"

    def set_weights(self, weights) -> bool:
        with self._lock:
            self.module.set_weights(weights)
        return True

    def drain(self) -> List[Dict[str, np.ndarray]]:
        """Completed, GAE'd episode fragments since the last drain."""
        with self._lock:
            out, self._complete = self._complete, []
            return out

    def get_metrics(self) -> Dict:
        with self._lock:
            recent = self._returns[-20:]
            return {"episode_return_mean":
                    float(np.mean(recent)) if recent else None,
                    "num_episodes": len(self._returns)}


class PolicyClient:
    """External-simulator side (reference: rllib PolicyClient): plain
    HTTP, no framework dependency beyond stdlib — an external process
    can copy this class wholesale."""

    def __init__(self, address: str, timeout: float = 60.0):
        self.address = address.rstrip("/")
        self.timeout = timeout

    def _post(self, route: str, body: Dict) -> Dict:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self.address + route, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:
                detail = str(e)
            raise RuntimeError(f"policy server: {detail}") from None
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        return self._post("/start_episode",
                          {"episode_id": episode_id})["episode_id"]

    def get_action(self, episode_id: str, observation) -> Any:
        obs = np.asarray(observation, np.float32).tolist()
        return self._post("/get_action", {"episode_id": episode_id,
                                          "observation": obs})["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._post("/log_returns", {"episode_id": episode_id,
                                    "reward": float(reward)})

    def end_episode(self, episode_id: str, observation) -> None:
        obs = np.asarray(observation, np.float32).tolist()
        self._post("/end_episode", {"episode_id": episode_id,
                                    "observation": obs})


class ExternalPPO:
    """PPO whose experience arrives from external simulators through
    PolicyServer actors instead of managed env runners (reference:
    rllib's policy-server workflow: server input + standard PPO
    training loop)."""

    def __init__(self, config, num_servers: int = 1):
        import dataclasses

        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl import envs as _envs
        from ray_tpu_torch.rl.learner import LearnerGroup
        from ray_tpu_torch.rl.rl_module import action_spec_of
        _envs.register_envs()
        resolve_device(config.learner_device)
        self.config = config
        probe = gym.make(config.env, **config.env_config)
        obs_shape = probe.observation_space.shape
        spec = action_spec_of(probe.action_space)
        probe.close()
        cfg_dict = dataclasses.asdict(config)
        cfg_dict["obs_shape"] = list(obs_shape)
        cfg_dict["action_spec"] = spec
        server_cls = rt.remote(PolicyServer)
        self.servers = [
            server_cls.options(max_concurrency=8).remote(cfg_dict)
            for _ in range(num_servers)]
        self.addresses = rt.get(
            [s.address.remote() for s in self.servers], timeout=120)
        obs_dim = int(np.prod(obs_shape))
        action_dim = spec.get("n") or spec["dim"]
        self.learner_group = LearnerGroup(cfg_dict, obs_dim, action_dim)
        self.iteration = 0
        self._sync_weights()

    def _sync_weights(self):
        import ray_tpu_torch as rt
        ref = rt.put(self.learner_group.get_weights())
        rt.get([s.set_weights.remote(ref) for s in self.servers],
               timeout=120)

    def training_step(self) -> Dict:
        import time as _time

        import ray_tpu_torch as rt
        t0 = _time.perf_counter()
        # wait for enough external experience to fill a train batch
        frags: List[Dict[str, np.ndarray]] = []
        rows = 0
        deadline = _time.monotonic() + self.config.train_batch_size / 10
        while rows < self.config.train_batch_size \
                and _time.monotonic() < deadline:
            new = [f for batch in rt.get(
                [s.drain.remote() for s in self.servers], timeout=60)
                for f in batch]
            frags.extend(new)
            rows += sum(len(f["obs"]) for f in new)
            if rows < self.config.train_batch_size:
                _time.sleep(0.05)
        metrics: Dict = {}
        if frags:
            batch = {k: np.concatenate([f[k] for f in frags])
                     for k in frags[0]}
            metrics = self.learner_group.update_from_batch(batch)
            self._sync_weights()
        server_metrics = rt.get(
            [s.get_metrics.remote() for s in self.servers], timeout=60)
        returns = [m["episode_return_mean"] for m in server_metrics
                   if m["episode_return_mean"] is not None]
        return {"episode_return_mean":
                float(np.mean(returns)) if returns else None,
                "num_env_steps_sampled": rows,
                "env_steps_per_s": rows / max(1e-9,
                                              _time.perf_counter() - t0),
                **metrics}

    def train(self) -> Dict:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def stop(self):
        import ray_tpu_torch as rt
        for s in self.servers:
            try:
                rt.kill(s)
            except Exception:
                pass
        self.servers = []
