"""Worker process entry point (reference:
python/ray/_private/workers/default_worker.py). The asyncio loop runs on the
main thread; task execution happens in executor threads, so user code inside
tasks can call the public API through the same threadsafe bridge the driver
uses."""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys

from ray_tpu_torch._private.proc_util import runtime_dir


def main():
    from ray_tpu_torch._private.proc_util import set_pdeathsig_from_env
    set_pdeathsig_from_env()
    parser = argparse.ArgumentParser()
    parser.add_argument("--node-address", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--store-path", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--session-name", default="session")
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "WARNING"),
        format=f"[worker {os.getpid()}] %(levelname)s %(message)s")

    # Nothing to pin here: the port's entry points take an explicit
    # device, and CUDA_VISIBLE_DEVICES arrives in the spawn environment.
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.worker import CoreWorker, Worker

    core = CoreWorker(mode="worker", gcs_address=args.gcs_address,
                      node_address=args.node_address,
                      store_path=args.store_path, node_id=args.node_id)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    from ray_tpu_torch.util import sanitizers
    loop.run_until_complete(core.start_async())
    if sanitizers.enabled():
        loop.call_soon(sanitizers.maybe_install)
    worker_mod.global_worker = Worker(core, owns_loop=False)

    # crash black box: continuous on-disk mirror of this worker's event
    # ring + metrics snapshots; clean shutdown seals it in stop_async
    from ray_tpu_torch._private import blackbox
    from ray_tpu_torch._private.config import cfg
    blackbox.configure(
        cfg.blackbox_dir or runtime_dir(args.session_name, "blackbox"),
        f"worker-{core.worker_id[:12]}", node_id=args.node_id,
        worker_id=core.worker_id)

    import ray_tpu_torch
    ray_tpu_torch._set_connected_from_worker(core)

    try:
        loop.run_forever()
    except KeyboardInterrupt:
        pass
    sys.exit(0)


if __name__ == "__main__":
    main()
