"""Phase 14 (c)-(d) of chip_smoke.py in a loop on one card.

The MPMD trainer's two stage actors train tpu-3b's recipe blocks cut to
each depth given; phase 13 (a)'s in-process pipeline at that depth is the
reference, as in the smoke. Each run kills stage 1's actor twice, as
phase 14 (d) does. Every stage loss the trainer sees is printed (step,
stages, cause, the confirmed boundary and the last dropped one) before it
recovers. A run that fails prints its error and the loop goes on; the
last line is a JSON summary of the runs at each depth, and the exit code
is 1 when any run failed. Each run has a runtime of its own, so a failed
run's actors do not hold the card's share of the next.

    python3 pipeline_elastic_probe.py [--layers 12,24] [--runs 4] [--logs DIR]

``--device cpu --layers 4`` rehearses it on the host, on llama-debug.
"""

import argparse
import json
import os
import sys
import time
import traceback

import torch

import chip_smoke as smoke


def lost_object_history(rt, error):
    """For an ObjectLostError in ``error``: the object's row of the GCS's
    object ledger (when it was sealed, spilled, restored, evicted or
    freed, where it lies, whether the leak sweep flagged it)."""
    import re
    m = re.search(r"ObjectLostError: ([0-9a-f]{16})", error)
    if m is None:
        return
    rows = rt._get_worker().gcs_call("list_object_ledger", limit=100000)
    for row in rows:
        if row.get("object_id", "").startswith(m.group(1)):
            print(f"probe: the lost object's ledger row {row}", flush=True)


def keep_logs(session, prefix):
    """Copy a failed run's GCS and node-manager logs (loop stalls, restore
    and spill errors) next to the probe's output."""
    import shutil

    from ray_tpu_torch._private.proc_util import runtime_dir
    for name in ("gcs.err", "node_manager.err"):
        path = runtime_dir(session, "logs", name)
        if os.path.exists(path):
            shutil.copy(path, f"{prefix}_{name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="12,24")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--logs", default=None,
                    help="a directory for a failed run's daemon logs")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    name = "tpu-3b" if cuda else "llama-debug"
    if cuda and not torch.cuda.is_available():
        smoke.fail("this probe needs a CUDA card")
    import ray_tpu_torch as rt
    from ray_tpu_torch import models, parallel, train
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as ops
    from ray_tpu_torch.train import mpmd

    os.environ["RAY_TPU_TORCH_DISABLE_GCE_METADATA"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line() if cuda else "host"
    print(f"card: {card}", flush=True)
    if cuda:
        _build.build(*smoke.KERNELS)

    prepare = mpmd.MPMDPipelineTrainer._prepare_recovery

    def traced(self, step, lost, cause=""):
        print(f"probe: stage loss at step {step}, stages {lost}, cause "
              f"{cause[:1000]!r}; confirmed boundary "
              f"{self._ckpt_step if self._snap_refs else None}, last "
              f"dropped boundary {self._dropped}", flush=True)
        return prepare(self, step, lost, cause)

    mpmd.MPMDPipelineTrainer._prepare_recovery = traced
    summary = {}
    for n in [int(x) for x in args.layers.split(",")]:
        _, in_process = smoke.run_pipeline(
            models, parallel, train, ops, card, 0.5, device=args.device,
            name=name, n_layers=n)
        smoke.release(args.device)
        runs = []
        for i in range(args.runs):
            t0 = time.perf_counter()
            rt.init(object_store_memory=(32 if cuda else 1) * 2 ** 30)
            session = rt._context.node.session_name
            try:
                smoke.runtime_pipeline(models, parallel, train, ops, card,
                                       in_process, device=args.device,
                                       name=name, n_layers=n)
                error = None
            except (Exception, SystemExit) as e:
                traceback.print_exc()
                error = f"{type(e).__name__}: {e}"[:2000]
                print(f"probe: after the failure, {smoke.arena_line(rt)}",
                      flush=True)
                lost_object_history(rt, error)
            finally:
                rt.shutdown()
            if error is not None and args.logs:
                keep_logs(session, os.path.join(args.logs,
                                                f"probe_{n}_{i + 1}"))
            runs.append({"s": round(time.perf_counter() - t0, 1),
                         "error": error})
            print(f"probe: {n} blocks, run {i + 1} of {args.runs}: "
                  f"{runs[-1]} [{card}]", flush=True)
        summary[n] = {"runs": len(runs),
                      "failed": sum(r["error"] is not None for r in runs),
                      "seconds": [r["s"] for r in runs]}
    print(json.dumps({"card": card, "depths": summary}), flush=True)
    sys.exit(1 if any(v["failed"] for v in summary.values()) else 0)


if __name__ == "__main__":
    main()
