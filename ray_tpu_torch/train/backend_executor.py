"""Worker-group orchestration for distributed training (counterpart of
``ray_tpu/train/backend_executor.py``; reference:
python/ray/train/_internal/backend_executor.py:68 BackendExecutor +
_internal/worker_group.py:102 WorkerGroup).

A training run = a placement group (gang) + one actor per worker +
rank/world wiring + a backend hook that starts ``torch.distributed``'s
default process group (a ``TCPStore`` rendezvous through the GCS KV;
NCCL on GPU workers, gloo on CPU ones). Worker failures surface as
ActorDiedError on the run refs. Restart granularity follows
``FailureConfig.restart_policy``: under "job" the trainer restarts the
whole gang from the latest checkpoint; under "stage" the executor
replaces ONLY the dead workers in place
(:meth:`BackendExecutor.replace_failed_workers` — same bundle, same rank,
latest-checkpoint resume pushed to the fresh actor) while the survivors
keep running. Per-worker replace is refused (job restart instead) when
the gang runs torch.distributed collectives: those fail as a unit."""

from __future__ import annotations

from typing import Callable, Dict, List

import ray_tpu_torch
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, _init_session
from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                placement_group, remove_placement_group)


class TrainWorker:
    """Actor hosting one training worker (needs max_concurrency=2 so
    poll() answers while run() blocks)."""

    def __init__(self):
        self._session = None
        self._context = None

    def setup(self, world_size: int, rank: int, local_rank: int,
              node_rank: int):
        self._context = TrainContext(world_size=world_size, world_rank=rank,
                                     local_rank=local_rank,
                                     node_rank=node_rank)
        self._session = _init_session(self._context)
        return True

    def set_resume_checkpoint(self, ckpt):
        if self._session is not None:
            self._session.latest_checkpoint = ckpt
        return True

    def set_dataset_shards(self, shards):
        if self._session is not None:
            self._session.dataset_shards = shards
        return True

    def get_node_ip(self):
        from ray_tpu_torch._private.rpc import node_ip_address
        return node_ip_address()

    def get_node_id(self):
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.core.node_id

    def setup_torch_distributed(self, group_name: str, world_size: int,
                                rank: int):
        # rank 0 serves a TCPStore on a free port of ITS host and
        # publishes it via GCS KV (the collective rendezvous helper)
        from ray_tpu_torch.util.collective import _init_torch_distributed
        _init_torch_distributed(world_size, rank, group_name)
        return True

    def run(self, fn, config):
        import inspect
        try:
            takes_arg = len(inspect.signature(fn).parameters) >= 1
        except (TypeError, ValueError):
            takes_arg = config is not None
        if takes_arg:
            fn(config if config is not None else {})
        else:
            fn()
        return True

    def poll(self):
        if self._session is None:
            return []
        return self._session.drain()

    def ping(self):
        return True


class BackendExecutor:
    def __init__(self, scaling_config: ScalingConfig,
                 use_torch_distributed: bool = False):
        self.scaling = scaling_config
        self.use_torch_distributed = use_torch_distributed
        self.pg = None
        self.workers: List = []
        self.run_refs: List = []
        self._bundles: List[Dict] = []
        self._dataset_shards = None
        self._run_fn = None
        self._run_config = None

    def start(self):
        if self.scaling.topology:
            # the JAX package gang-schedules a TPU pod slice from the
            # slice resources its TPU accelerator manager injects; the
            # GPU manager injects none, and which unit of GPU hosts a
            # gang should be pinned to is an open design question
            raise NotImplementedError(
                "a gang pinned to a slice topology is not ported yet "
                "(ROADMAP.md, Queue A item A3c-2)")
        n = self.scaling.num_workers
        res = self.scaling.worker_resources()
        bundles = [dict(res) for _ in range(n)]
        self.pg = placement_group(bundles,
                                  strategy=self.scaling.placement_strategy)
        if not self.pg.wait(timeout=60):
            remove_placement_group(self.pg)
            raise RuntimeError(
                f"placement group for {bundles} not schedulable")
        self._bundles = bundles
        self.workers = [self._spawn_worker(i) for i in range(n)]
        # ranks: worker order; local/node ranks by node ip grouping
        ips = ray_tpu_torch.get([w.get_node_ip.remote()
                                 for w in self.workers], timeout=120)
        node_order: Dict[str, int] = {}
        local_counters: Dict[str, int] = {}
        setups = []
        self._setup_args: List[tuple] = []
        for rank, (w, ip) in enumerate(zip(self.workers, ips)):
            node_rank = node_order.setdefault(ip, len(node_order))
            local_rank = local_counters.get(ip, 0)
            local_counters[ip] = local_rank + 1
            self._setup_args.append((n, rank, local_rank, node_rank))
            setups.append(w.setup.remote(n, rank, local_rank, node_rank))
        ray_tpu_torch.get(setups, timeout=120)
        if self.use_torch_distributed:
            import uuid
            group = f"train-{uuid.uuid4().hex[:8]}"
            ray_tpu_torch.get([w.setup_torch_distributed.remote(group, n, r)
                               for r, w in enumerate(self.workers)],
                              timeout=300)

    def set_resume_checkpoint(self, ckpt):
        ray_tpu_torch.get([w.set_resume_checkpoint.remote(ckpt)
                           for w in self.workers], timeout=60)

    def setup_datasets(self, datasets, data_config=None):
        """Streaming-split datasets across the worker gang (reference:
        DataConfig streaming split into Train, _internal/data_config.py:
        one executing stream per dataset, one disjoint shard per worker)."""
        from ray_tpu_torch.data.split import streaming_split
        split_names = getattr(data_config, "datasets_to_split", "all") \
            if data_config is not None else "all"
        n = len(self.workers)
        # locality hints (fetched lazily, once, only if a split happens):
        # bundles already resident on a worker's node deal to that
        # worker (split.py locality-aware dealing)
        hints_box: List = []

        def _hints():
            if not hints_box:
                try:
                    hints_box.append(ray_tpu_torch.get(
                        [w.get_node_id.remote() for w in self.workers],
                        timeout=60))
                except Exception:
                    hints_box.append(None)
            return hints_box[0]

        per_worker = {i: {} for i in range(n)}
        for name, ds in datasets.items():
            split = split_names == "all" or name in split_names
            if split and n > 1:
                shards = streaming_split(ds, n, locality_hints=_hints())
                for i in range(n):
                    per_worker[i][name] = shards[i]
            else:
                # replicated: each worker gets its own full stream
                for i in range(n):
                    per_worker[i][name] = streaming_split(ds, 1)[0]
        # the ORIGINAL coordinator handles live in these iterators: they
        # must outlive the run (worker-side copies are non-owning, and
        # dropping the originals would kill the coordinators mid-stream)
        self._dataset_shards = per_worker
        ray_tpu_torch.get([w.set_dataset_shards.remote(per_worker[i])
                           for i, w in enumerate(self.workers)],
                          timeout=120)

    def _spawn_worker(self, bundle_index: int):
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        return actor_cls.options(
            max_concurrency=2,
            resources=dict(self._bundles[bundle_index]),  # consumes bundle
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                self.pg, placement_group_bundle_index=bundle_index),
        ).remote()

    def start_training(self, fn: Callable, config):
        self._run_fn, self._run_config = fn, config
        self.run_refs = [w.run.remote(fn, config) for w in self.workers]
        return self.run_refs

    def poll_results(self) -> List[List[Dict]]:
        """Drain buffered report() rows per worker. A dead worker
        contributes an empty list instead of failing the sweep — its
        death is surfaced by finished() / failed_worker_indexes(), and
        under restart_policy="stage" the survivors' metrics must keep
        flowing while the replacement builds."""
        out: List[List[Dict]] = []
        for w in self.workers:
            try:
                out.append(ray_tpu_torch.get(w.poll.remote(), timeout=60))
            except Exception:
                out.append([])
        return out

    def finished(self):
        """(done, error): done when every run ref resolved; error holds the
        first worker failure."""
        ready, not_ready = ray_tpu_torch.wait(self.run_refs,
                                              num_returns=len(self.run_refs),
                                              timeout=0)
        if not_ready:
            # check for failed ones among ready
            for r in ready:
                try:
                    ray_tpu_torch.get(r, timeout=1)
                except Exception as e:
                    return True, e
            return False, None
        try:
            ray_tpu_torch.get(self.run_refs, timeout=5)
            return True, None
        except Exception as e:
            return True, e

    # -------------------------------------------------- per-worker replace
    def supports_worker_replace(self) -> bool:
        """Per-worker replace is sound only when workers are independent
        processes: a torch.distributed gang's collectives hang on a member
        swap (the group's rendezvous is fixed at its start), so it
        degrades to the job-level restart."""
        return not self.use_torch_distributed

    def failed_worker_indexes(self) -> List[int]:
        """Workers whose run ref resolved with an error (actor death or
        a raised training loop); survivors' refs stay pending."""
        failed = []
        for i, ref in enumerate(self.run_refs):
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not ready:
                continue
            try:
                ray_tpu_torch.get(ref, timeout=1)
            except Exception:
                failed.append(i)
        return failed

    def replace_failed_workers(self, resume_checkpoint=None) -> List[int]:
        """Build a fresh actor in each dead worker's bundle, re-wire its
        rank, push the latest checkpoint + its dataset shards, and restart
        its training loop — the surviving workers never stop. Returns the replaced indexes
        (empty when nothing was dead or replace is unsupported)."""
        if not self.supports_worker_replace():
            return []
        failed = self.failed_worker_indexes()
        if not failed:
            return []
        from ray_tpu_torch._private import events
        for i in failed:
            try:
                ray_tpu_torch.kill(self.workers[i])
            except Exception:
                pass   # already dead
            w = self._spawn_worker(i)
            ray_tpu_torch.get(w.setup.remote(*self._setup_args[i]),
                              timeout=120)
            if resume_checkpoint is not None:
                ray_tpu_torch.get(w.set_resume_checkpoint.remote(
                    resume_checkpoint), timeout=60)
            if self._dataset_shards is not None:
                ray_tpu_torch.get(w.set_dataset_shards.remote(
                    self._dataset_shards[i]), timeout=120)
            self.workers[i] = w
            self.run_refs[i] = w.run.remote(self._run_fn, self._run_config)
            events.record_instant(
                "train.worker_replaced", category="train", rank=i,
                resumed=bool(resume_checkpoint is not None))
        return failed

    def shutdown(self):
        self._dataset_shards = None
        self.run_refs = []
        # gang teardown: surviving workers of a partially-failed gang
        # must die with it (a half-dead gang can't run collectives and
        # its actors would leak leases + cards otherwise)
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None
