"""The port's shared-memory object store (ray_tpu_torch/native/shm_store.cpp
through ray_tpu_torch/_private/object_store.py) and its tensor path through
the runtime (ray_tpu_torch/_private/serialization.py):

- the core cases of tests/test_object_store.py: a round trip, zero-copy
  numpy reads, and a client SIGKILLed inside rt_create while it holds a
  stripe mutex, which the survivors' robust mutex repairs;
- CPU tensors (fp32, bf16, int8, a non-contiguous view) through put/get
  and as task arguments and returns: bitwise equal, and read zero-copy
  (the result's storage lies in the arena's mapping);
- a CUDA tensor refuses to come back as a CPU tensor in a process
  without a card;
- a numpy value takes the same bytes in the store in both runtimes.
"""

import ctypes
import multiprocessing
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.object_store import ObjectStoreClient
from ray_tpu_torch.util.chaos import ShmCreateKiller


def oid(n: int) -> bytes:
    return n.to_bytes(20, "big")


@pytest.fixture()
def striped_store():
    path = "/dev/shm/raytpu_torch_test_striped_%d" % os.getpid()
    s = ObjectStoreClient(path, create=True, size=64 * 1024 * 1024,
                          stripes=4)
    try:
        yield s
    finally:
        s.close()
        os.unlink(path)


def _arena_range(store: ObjectStoreClient):
    base = ctypes.addressof(store._mem)
    return base, base + ctypes.sizeof(store._mem)


def test_store_roundtrip_and_zero_copy_numpy(striped_store):
    s = striped_store
    payload = b"hello world" * 1000
    assert s.put_bytes(oid(1), payload, metadata=b"meta")
    buf = s.get(oid(1))
    assert bytes(buf.data) == payload and buf.metadata == b"meta"
    assert s.get(oid(2)) is None
    arr = np.arange(100000, dtype=np.float32)
    s.put_bytes(oid(3), arr.tobytes())
    out = np.frombuffer(s.get(oid(3)).data, dtype=np.float32)
    np.testing.assert_array_equal(out, arr)
    lo, hi = _arena_range(s)
    assert lo <= out.ctypes.data < hi


def _chaos_put_loop(path, spec):
    # arm BEFORE the first native create: the spec is parsed once per
    # process (spawn context => fresh interpreter => fresh parse)
    os.environ[ShmCreateKiller.SPEC_ENV] = spec
    from ray_tpu_torch._private.object_store import \
        ObjectStoreClient as Client
    c = Client(path)
    for i in range(1000):
        try:
            c.put_bytes((7_000_000 + i).to_bytes(20, "big"), b"\xab" * 4096)
        except Exception:
            pass
    os._exit(3)  # survived 1000 puts: the injection never fired


def test_kill_mid_create_repairs_stripe(striped_store):
    """A client SIGKILLed inside rt_create while holding a stripe mutex
    must not take the store down: survivors hit EOWNERDEAD, repair the
    stripe, and keep serving puts."""
    s = striped_store
    for i in range(8):
        assert s.put_bytes(oid(60000 + i), b"\x22" * 1024)
    killer = ShmCreateKiller(nth_create=3)
    victim = multiprocessing.get_context("spawn").Process(
        target=_chaos_put_loop, args=(s.path, killer.spec()))
    victim.start()
    killer.assert_killed(victim)
    st = s.stats()          # walks every stripe: performs the repair
    assert st["stripe_repairs"] >= 1 and st["poisoned"] == 0
    for i in range(64):
        assert s.put_bytes(oid(70000 + i), b"\x33" * 2048)
        buf = s.get(oid(70000 + i))
        assert bytes(buf.data) == b"\x33" * 2048
        buf.close()
    assert s.stats()["poisoned"] == 0


# ------------------------------------------------------- through the runtime

@pytest.fixture(scope="module")
def cluster():
    ctx = rt.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    try:
        yield ctx
    finally:
        rt.shutdown()


def _tensors():
    """Each above the inline threshold (100 KiB), so it goes through the
    arena rather than inside an RPC frame."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(300, 400, generator=g)
    return {
        "fp32": base.clone(),
        "bf16": base.to(torch.bfloat16),
        "int8": torch.randint(-128, 128, (300, 400), dtype=torch.int8,
                              generator=g),
        "non_contiguous": base.t()[::2],      # strided view
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "non_contiguous"])
def test_cpu_tensor_put_get_zero_copy(cluster, kind):
    t = _tensors()[kind]
    got = rt.get(rt.put(t))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert _same(got, t)
    assert got.is_contiguous()
    lo, hi = _arena_range(rt._get_worker().core.store)
    assert lo <= got.data_ptr() < hi, "the tensor was copied out"


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "non_contiguous"])
def test_cpu_tensor_as_task_argument(cluster, kind):
    t = _tensors()[kind]

    @rt.remote
    def echo(x):
        return (str(x.dtype), tuple(x.shape), x.is_contiguous(),
                x.float().sum().item(), x * 2)

    dtype, shape, contiguous, total, doubled = rt.get(echo.remote(t))
    assert dtype == str(t.dtype) and shape == tuple(t.shape) and contiguous
    assert total == t.contiguous().float().sum().item()
    assert _same(doubled, t * 2)


def test_cuda_tensor_needs_a_card_to_come_back():
    """A CUDA tensor is rebuilt on the reader's current CUDA device; a
    reader without one gets an error, never a CPU tensor. (A stand-in
    payload: the reduction of a real CUDA tensor, which this machine
    cannot make, differs only in copying it to the host first.)"""
    t = torch.arange(6, dtype=torch.float32)
    rebuild, args = serialization._reduce_tensor(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rebuild(args[0], args[1], args[2], args[3], True)


def test_numpy_store_bytes_equal_in_both_runtimes():
    """A numpy value's store layout (data region and metadata) is the
    same in both runtimes: the port's tensor reduction leaves numpy
    untouched."""
    from ray_tpu._private import serialization as jax_serialization
    for value in (np.arange(1_000_000, dtype=np.float32),
                  {"a": np.ones((64, 64), np.int8), "b": [1, 2]}):
        mine = serialization.serialize(value)
        theirs = jax_serialization.serialize(value)
        assert mine.data_size() == theirs.data_size()
        assert mine.store_meta() == theirs.store_meta()
