"""Process-lifetime plumbing shared by every ray_tpu_torch daemon.

Without it, daemons outlive a green test suite by the hundred:
daemons are spawned with start_new_session=True (so they never
get the driver's SIGINT), and nothing tied their lifetime to their
spawner. The reference solves this with parent-death signals and the
raylet's bounded GCS-reconnect timeout
(src/ray/raylet/main.cc:123 shutdown path,
gcs_rpc_server_reconnect_timeout_s); this module is the TPU-runtime
equivalent:

- the SPAWNER exports RAY_TPU_TORCH_PDEATHSIG=<signo> in the child's env;
- the CHILD calls set_pdeathsig_from_env() first thing in main(), which
  arms prctl(PR_SET_PDEATHSIG) against ITS OWN parent — so a dead
  driver reaps its GCS/node manager, and a dead node manager reaps its
  workers, transitively, even on SIGKILL.

Detached clusters (`ray_tpu_torch start --head`) simply don't export the
variable and outlive the CLI as before.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
from typing import Iterable

PDEATHSIG_ENV = "RAY_TPU_TORCH_PDEATHSIG"
PDEATHSIG_PARENT_ENV = "RAY_TPU_TORCH_PDEATHSIG_PARENT"
_PR_SET_PDEATHSIG = 1


def runtime_dir(*parts: str) -> str:
    """Where the runtime keeps its files on this host (logs, sockets,
    black boxes, spill files, the runtime_env cache): ``raytpu_torch``
    under the temporary directory (``TMPDIR``), which the daemons and
    workers inherit, so runtimes started under different ``TMPDIR``s
    never meet."""
    return os.path.join(tempfile.gettempdir(), "raytpu_torch", *parts)


def set_pdeathsig_from_env() -> None:
    """Arm PR_SET_PDEATHSIG from the spawner's env marker (no-op when
    unset or on non-Linux). Call first thing in a daemon's main()."""
    raw = os.environ.get(PDEATHSIG_ENV)
    if not raw:
        return
    try:
        signo = int(raw)
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signo, 0, 0, 0)
        # the parent may have died in the fork->here window, in which
        # case the signal was never delivered. Compare against the
        # RECORDED spawner pid — a bare getppid()==1 check would
        # self-kill legitimate children of a PID-1 driver (containers)
        expected = os.environ.get(PDEATHSIG_PARENT_ENV)
        if expected and os.getppid() != int(expected):
            os.kill(os.getpid(), signo)
    except Exception:
        pass    # best-effort; the bounded-reconnect timeout still holds


def child_env(env: dict | None = None, signo: int = signal.SIGTERM) -> dict:
    """Env dict for a non-detached child: spawner's env + the
    parent-death marker (and the spawner's pid, to detect a parent that
    died before the child could arm the signal)."""
    out = dict(os.environ if env is None else env)
    out[PDEATHSIG_ENV] = str(int(signo))
    out[PDEATHSIG_PARENT_ENV] = str(os.getpid())
    return out


def kill_process_group(proc: subprocess.Popen,
                       sig: int = signal.SIGKILL) -> None:
    """Kill a start_new_session child AND anything it spawned into its
    process group (user tasks fork; reaping just the leader leaks the
    grandchildren)."""
    if proc.pid is None:
        return
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass


def find_session_processes(marker: str) -> Iterable[int]:
    """PIDs of live ray_tpu_torch daemons whose environment carries the given
    RAY_TPU_TORCH_TEST_SESSION marker value (used by the suite-final hygiene
    check). Scans /proc; skips unreadable entries."""
    me = os.getpid()
    for pid_s in os.listdir("/proc"):
        if not pid_s.isdigit() or int(pid_s) == me:
            continue
        try:
            with open(f"/proc/{pid_s}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            if state == "Z":    # exited, just not yet reaped
                continue
            with open(f"/proc/{pid_s}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
            if b"ray_tpu_torch" not in cmd:
                continue
            with open(f"/proc/{pid_s}/environ", "rb") as f:
                env = f.read()
            if f"RAY_TPU_TORCH_TEST_SESSION={marker}".encode() in env:
                yield int(pid_s)
        except OSError:
            continue


def format_thread_stacks() -> dict:
    """{thread_name: formatted stack} for every live thread in THIS
    process — the in-process substrate of `ray_tpu_torch stack` (reference:
    `ray stack` shells out to py-spy, ray/scripts/scripts.py; here every
    daemon serves its own frames over RPC, no ptrace needed)."""
    import sys
    import threading
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[f"{name} ({ident})"] = "".join(traceback.format_stack(frame))
    return out
