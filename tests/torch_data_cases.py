"""Helpers of the Data tests (``tests/test_torch_data*.py``): an eager
in-process runtime that runs either package's Data plans without a
cluster, and the train loops the port's workers run. JAX-free: the port's
workers import this module by name.

The eager runtime stands in for ``remote``/``get``/``put``/``wait``/
``kill``: a task runs when it is submitted, an actor is a plain object,
``num_returns`` of 2 or more gives a list of refs, and "streaming" a
generator of refs. It lets the JAX package's Data, which is JAX-free
apart from ``iter_jax_batches``, compute the reference result of a plan
in the test's own process, while the port runs the same plan on its own
runtime. Nothing that decides a result depends on the runtime: task
seeds derive from (seed, phase, index), partition counts from the CPU
count (both 4 here) and block order from the plan.
"""

import contextlib


class Ref:
    __slots__ = ("val",)

    def __init__(self, val):
        self.val = val


def unwrap(x):
    return x.val if isinstance(x, Ref) else x


class _Method:
    def __init__(self, fn, opts=None):
        self.fn, self.opts = fn, opts or {}

    def options(self, **kw):
        return _Method(self.fn, {**self.opts, **kw})

    def remote(self, *args, **kwargs):
        out = self.fn(*[unwrap(a) for a in args],
                      **{k: unwrap(v) for k, v in kwargs.items()})
        n = self.opts.get("num_returns", 1)
        if n == "streaming":
            return (Ref(v) for v in out)
        if n == 1:
            return Ref(out)
        out = list(out)
        assert len(out) == n, (len(out), n)
        return [Ref(v) for v in out]


class _Actor:
    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        return _Method(getattr(self._obj, name))


class _ActorClass:
    def __init__(self, cls):
        self.cls = cls

    def options(self, **_kw):
        return self

    def remote(self, *args, **kwargs):
        return _Actor(self.cls(*[unwrap(a) for a in args],
                               **{k: unwrap(v) for k, v in kwargs.items()}))


def _remote(*args, **opts):
    def make(obj):
        if isinstance(obj, type):
            return _ActorClass(obj)
        return _Method(obj, opts)
    if len(args) == 1 and callable(args[0]) and not opts:
        return make(args[0])
    return make


def _get(refs, **_kw):
    if isinstance(refs, list):
        return [unwrap(r) for r in refs]
    return unwrap(refs)


def _wait(refs, num_returns=1, timeout=None):
    refs = list(refs)
    return refs[:num_returns], refs[num_returns:]


@contextlib.contextmanager
def eager_runtime(pkg):
    """Run ``pkg``'s Data (``ray_tpu`` or ``ray_tpu_torch``) on the eager
    runtime inside the block."""
    fakes = {"remote": _remote, "get": _get, "wait": _wait,
             "put": Ref, "kill": lambda *a, **k: None,
             "is_initialized": lambda: False}
    saved = {k: getattr(pkg, k) for k in fakes}
    for k, v in fakes.items():
        setattr(pkg, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(pkg, k, v)


# ------------------------------------------------- actors of the tests
# (here, not in a test module, so that their workers import no torch)

class AddState:
    """A stateful UDF: built once per pool actor."""

    def __init__(self, offset):
        self.offset = offset

    def __call__(self, batch):
        return {"x": batch["x"] + self.offset}


class WhereAmI:
    """A UDF class asked for a GPU: it reports the mask its actor got."""

    def __call__(self, batch):
        import os

        import numpy as np

        import ray_tpu_torch as rt
        n = len(batch["x"])
        return {"x": batch["x"],
                "mask": np.array([os.environ.get("CUDA_VISIBLE_DEVICES")]
                                 * n, dtype=object),
                "ids": np.array([",".join(rt.get_gpu_ids())] * n,
                                dtype=object)}


def _ident(i):
    return i


class Submitter:
    """An actor that runs tasks of its own, as a split coordinator does."""

    def run(self, n):
        import ray_tpu_torch as rt
        task = rt.remote(_ident)
        return sum(rt.get([task.remote(i) for i in range(n)]))


# ---------------------------------------------------------- train loops

class Tally:
    """Collects what each train worker read (by rank and attempt)."""

    def __init__(self):
        self.seen = []

    def add(self, rank, ids, finished):
        self.seen.append((rank, list(ids), finished))
        return True

    def get(self):
        return self.seen


def ingest_loop(config):
    """Each worker reads its shard of "train" through iter_torch_batches
    on the CPU and tells the "ingest-tally" actor every id it read. With
    ``crash_marker``, rank 1 tells what it read so far and exits once
    after its first batch; its replacement then reads the rest of the
    shard, pushed to it again by the executor."""
    import os

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    rank = train.get_context().get_world_rank()
    tally = rt.get_actor("ingest-tally")
    shard = train.get_dataset_shard("train")
    seen = []
    for batch in shard.iter_torch_batches(
            batch_size=4, device="cpu", drop_last=False,
            dtypes=torch.int64, prefetch=1, device_prefetch=1):
        seen.extend(batch["id"].tolist())
        marker = config.get("crash_marker")
        if marker and rank == 1 and not os.path.exists(marker):
            rt.get(tally.add.remote(rank, seen, False), timeout=60)
            with open(marker, "w") as f:
                f.write("crashed")
            os._exit(1)
    rt.get(tally.add.remote(rank, seen, True), timeout=60)
    train.report({"rank": rank, "rows": len(seen)})
