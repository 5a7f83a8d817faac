"""Phase 16 (c)-(d) of chip_smoke.py in a loop: two replicas, one killed
mid-stream, the stream resumed on the survivor (ROADMAP C16).

Each run starts a runtime of its own, serves ``name`` cut to 2 layers
(``--device cpu``: llama-debug) or 8 (``--device cuda``: tpu-7b, as the
smoke's (c)-(d)) from two replicas, and holds what the smoke holds. A
run that fails prints its error and the loop goes on; the last line is a
JSON summary (runs, failures, each run's seconds), and the exit code is
1 when any run failed.

    python3 serve_resume_probe.py [--device cpu] [--runs 20]
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import chip_smoke as smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    import ray_tpu_torch as rt
    from ray_tpu_torch import inference, models, serve
    from ray_tpu_torch.ops import attention as ops
    os.environ["RAY_TPU_TORCH_DISABLE_GCE_METADATA"] = "1"
    card = smoke.card_line() if cuda else "host"
    cls, _ = smoke._serve_classes(inference)
    if cuda:
        cfg = dataclasses.replace(models.MODEL_REGISTRY["tpu-7b"],
                                  n_layers=8)
        engine = dict(n_slots=8, max_len=1024, prefill_chunk=128,
                      prefill_budget=256)
    else:
        cfg = dataclasses.replace(models.MODEL_REGISTRY["llama-debug"],
                                  n_layers=2)
        engine = dict(n_slots=4, max_len=256, prefill_chunk=32,
                      prefill_budget=64)
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        marks = tempfile.mkdtemp(prefix="resume_probe_")
        rt.init(num_cpus=8, object_store_memory=(32 if cuda else 1) * 2 ** 30)
        error = None
        try:
            smoke.serve_weight_plane_and_kill(
                rt, serve, models, ops, card, cls, os.path.join(marks, "c"),
                args.device, cfg, engine)
        except (Exception, SystemExit) as e:
            traceback.print_exc()
            error = f"{type(e).__name__}: {e}"[:1000]
        finally:
            try:
                serve.shutdown()
            finally:
                rt.shutdown()
        runs.append({"s": round(time.perf_counter() - t0, 1),
                     "error": error})
        print(f"probe: run {i + 1} of {args.runs}: {runs[-1]} [{card}]",
              flush=True)
    failed = sum(r["error"] is not None for r in runs)
    print(json.dumps({"card": card, "runs": len(runs), "failed": failed,
                      "seconds": [r["s"] for r in runs]}), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
