"""Run a function in a local gloo world of N ranks, for the mesh tests.

``World(target, world_size, workdir, timeout)`` starts one process
(``python -m tests.torch_world``), which imports torch once, forks the N
ranks and supervises them: each rank sets one thread, starts the default
process group from a ``FileStore`` in ``workdir`` and calls
``target(rank, world_size, workdir)``, a ``"module:function"`` that must
not import JAX. Rank 0's return value comes back (``torch.save`` through
``workdir``). When any rank fails, the supervisor kills the others at once;
when the world outlives ``timeout`` seconds, the whole process group is
killed. Either way the test fails with the ranks' errors (and the Python
stack of a rank that died on a fatal signal), and never hangs.
"""

from __future__ import annotations

import importlib
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class World:
    """A started world: ``join()`` waits for it and returns rank 0's
    result, so the caller can compute its references meanwhile."""

    def __init__(self, target: str, world_size: int, workdir,
                 timeout: float = 60.0):
        self.target, self.world_size = target, world_size
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tests.torch_world", target,
             str(world_size), str(self.workdir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True)

    def join(self):
        proc, workdir = self.proc, self.workdir
        name = f"world {self.target} x{self.world_size}"
        try:
            out, _ = proc.communicate(
                timeout=max(0.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            # the ranks print their stacks on SIGUSR1, then all go
            os.killpg(proc.pid, signal.SIGUSR1)
            time.sleep(1.0)
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            stacks = "".join(f"rank {p.name[5:]}:\n{p.read_text()[-1500:]}"
                             for p in sorted(workdir.glob("stack*")))
            raise AssertionError(
                f"{name} still running after {self.timeout}s; killed. "
                f"Where each rank was:\n{stacks}\n"
                f"{out.decode(errors='replace')[-2000:]}")
        if proc.returncode != 0:
            errs = "".join(p.read_text() for p in sorted(workdir.glob("err*")))
            # a rank that died on a fatal signal (SIGSEGV, SIGABRT from
            # glibc's malloc checks, ...) left its Python stack here
            errs += "".join(f"rank {p.name[5:]} died:\n{p.read_text()}"
                            for p in sorted(workdir.glob("fatal*"))
                            if p.read_text().strip())
            raise AssertionError(
                f"{name} failed (rc {proc.returncode}):\n{errs[-6000:]}\n"
                f"{out.decode(errors='replace')[-2000:]}")
        import torch
        return torch.load(workdir / "result.pt", weights_only=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # a test that failed before joining stops the world at once
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()


def _rank_main(target: str, rank: int, world_size: int, workdir: Path):
    import faulthandler

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import init_world

    stacks = open(workdir / f"stack{rank}", "w")
    faulthandler.register(signal.SIGUSR1, file=stacks)
    faulthandler.enable(file=open(workdir / f"fatal{rank}", "w"))
    torch.set_num_threads(1)
    init_world(store=dist.FileStore(str(workdir / "store"), world_size),
               rank=rank, world_size=world_size, device="cpu")
    mod, fn = target.split(":")
    result = getattr(importlib.import_module(mod), fn)(
        rank, world_size, workdir)
    dist.barrier()
    if rank == 0:
        torch.save(result, workdir / "result.pt")
    dist.destroy_process_group()


def _supervise(target: str, world_size: int, workdir: Path) -> int:
    import torch  # noqa: F401  (imported once, before the ranks fork)
    import torch.distributed.tensor  # noqa: F401
    importlib.import_module(target.split(":")[0])
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)
    pids = {}
    for rank in range(world_size):
        pid = os.fork()
        if pid == 0:
            code = 0
            try:
                _rank_main(target, rank, world_size, workdir)
            except BaseException:
                (workdir / f"err{rank}").write_text(
                    f"rank {rank}:\n{traceback.format_exc()}")
                code = 1
            finally:
                sys.stdout.flush()
                os._exit(code)
        pids[pid] = rank
    failed = False
    while pids:
        pid, status = os.wait()
        pids.pop(pid, None)
        if os.waitstatus_to_exitcode(status) != 0 and not failed:
            failed = True
            for other in pids:
                os.kill(other, signal.SIGKILL)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(_supervise(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3])))
