"""The port's mutable channels and compiled DAG (ray_tpu_torch/
experimental/channel.py, ray_tpu_torch/dag/, native/mutable_channel.cpp),
on the CPU:

- the five cases of tests/test_dag_channels.py, run on the port: a
  channel in one process, a cross-process reader under back-pressure, a
  linear two-actor DAG, a multi-output DAG and the Echo DAG's round trip
  against the RPC path; after each DAG's teardown every actor loop has
  returned "closed" and no channel file of the DAG is left;
- the port's mutable_channel_selftest under ASan and UBSan, as
  tests/test_sanitizers.py runs the JAX package's copy;
- a two-stage llama-debug DAG (one block per stage actor, weights
  converted from JAX block trees with ``block_params_from_jax`` and cut
  per stage with ``stage_state_dict``) against the JAX package's
  ``Block`` applied twice on the same input, in fp32 within rtol 1e-5,
  atol 1e-5: the bound tests/test_torch_pipeline_world.py holds the
  port's pipeline stages' outputs to.
"""

import glob
import multiprocessing
import os
import subprocess
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import (CHANNEL_PREFIX, Channel,
                                                ChannelClosed)
from tests import torch_dag_cases as cases

STAGE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ray_start():
    ctx = rt.init(num_cpus=6, object_store_memory=128 * 1024 * 1024)
    yield ctx
    rt.shutdown()


def _chan_path(tag):
    return f"/dev/shm/raytpu_torch_test_{tag}_{os.getpid()}"


def _torn_down(dag):
    """teardown() closes every edge: each loop returns "closed" and no
    file of the DAG's channels is left. Then the DAG's actors are killed,
    so that the next test finds the module runtime's CPUs free: left to
    the collection of their handles, they held five of its six CPUs when
    the two-stage test began, and under load its second stage actor
    waited out compile's 60 s for a CPU ("insufficient resources for
    actor")."""
    dag.teardown()
    assert set(rt.get(dag._loop_refs, timeout=30)) == {"closed"}
    assert dag.prefix.startswith(CHANNEL_PREFIX)
    assert not glob.glob(f"{glob.escape(dag.prefix)}*")
    for handle in dag._actors.values():
        rt.kill(handle)


def test_channel_same_process():
    path = _chan_path("chan1")
    ch = Channel(path, max_size=1 << 16, num_readers=1, create=True)
    reader = Channel(path)
    ch.write({"x": 1})
    assert reader.read() == {"x": 1}
    ch.write([1, 2, 3])
    assert reader.read() == [1, 2, 3]
    ch.destroy()
    assert not os.path.exists(path)


def _reader_proc(path, out_q):
    ch = Channel(path)
    vals = []
    try:
        while True:
            vals.append(ch.read(timeout_s=10))
    except ChannelClosed:
        pass
    out_q.put(vals)


def test_channel_cross_process_backpressure():
    path = _chan_path("chan2")
    ch = Channel(path, max_size=1 << 16, num_readers=1, create=True)
    q = multiprocessing.Queue()
    p = multiprocessing.Process(target=_reader_proc, args=(path, q))
    p.start()
    for i in range(20):
        ch.write(i)     # blocks until reader acks previous version
    ch.close()
    vals = q.get(timeout=30)
    p.join(timeout=10)
    assert vals == list(range(20))   # every version seen exactly once
    ch.destroy()


def test_compiled_dag_linear(ray_start):
    @rt.remote
    class AddOne:
        def add(self, x):
            return x + 1

    @rt.remote
    class Double:
        def mul(self, x):
            return x * 2

    a, b = AddOne.remote(), Double.remote()
    with InputNode() as inp:
        mid = a.add.bind(inp)
        out = b.mul.bind(mid)
    dag = out.experimental_compile()
    try:
        assert dag.execute(5) == 12
        assert dag.execute(10) == 22
        # repeated execution is the point: run many
        for i in range(50):
            assert dag.execute(i) == (i + 1) * 2
    finally:
        _torn_down(dag)


def test_compiled_dag_multi_output(ray_start):
    @rt.remote
    class Worker1:
        def inc(self, x):
            return x + 1

        def dec(self, x):
            return x - 1

    w1, w2 = Worker1.remote(), Worker1.remote()
    with InputNode() as inp:
        o1 = w1.inc.bind(inp)
        o2 = w2.dec.bind(inp)
        dag = MultiOutputNode([o1, o2]).experimental_compile()
    try:
        assert dag.execute(10) == [11, 9]
    finally:
        _torn_down(dag)


def test_compiled_dag_throughput(ray_start):
    @rt.remote
    class Echo:
        def ping(self, x):
            return x

    e = Echo.remote()
    with InputNode() as inp:
        dag = e.ping.bind(inp).experimental_compile()
    try:
        for _ in range(5):
            dag.execute(0)
        n = 200
        t0 = time.perf_counter()
        for i in range(n):
            dag.execute(i)
        dt = time.perf_counter() - t0
        per_call_us = dt / n * 1e6
        # must be far below the RPC path (~1ms); expect tens of µs
        assert per_call_us < 2000, per_call_us
    finally:
        _torn_down(dag)


def test_mutable_channel_selftest_asan_ubsan():
    """The port's channel under ASan+UBSan: the standalone harness's
    version-gated hand-off with two reader threads on separate opens,
    back-pressure, timeouts and close; a sanitizer finding aborts with a
    nonzero exit and its report on stderr."""
    from ray_tpu_torch.native.build import build_selftest
    binary = build_selftest("mutable_channel_selftest")
    r = subprocess.run([binary, _chan_path("rtc_selftest")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-4000:])
    assert "OK" in r.stdout


def _jax_two_blocks(trees, x, L):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import MODEL_REGISTRY
    from ray_tpu.models.transformer import Block, unpartitioned_params
    cfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                              dtype=jnp.float32, param_dtype=jnp.float32,
                              scan_layers=False, remat=False)
    block = Block(cfg)
    positions = jnp.broadcast_to(jnp.arange(L)[None, :], (x.shape[0], L))

    @jax.jit
    def run(ps, h):
        with unpartitioned_params():
            for p in ps:
                h, _aux = block.apply({"params": p}, h, positions)
        return h
    return np.array(run([jax.tree.map(jnp.asarray, t) for t in trees],
                          jnp.asarray(x)))


def test_two_stage_llama_debug_dag_matches_jax(ray_start):
    """stage 0 (block 0) -> stage 1 (block 1) through channels, three
    executions of different inputs, each against the JAX blocks."""
    from ray_tpu_torch.models import block_params_from_jax, stage_state_dict
    from tests.torch_pipeline_cases import jax_block_tree
    cfg = cases.config()
    rng = np.random.RandomState(0)
    trees = [jax_block_tree(rng, cfg) for _ in range(2)]
    whole = {f"layers.{i}.{k}": v.numpy() for i, t in enumerate(trees)
             for k, v in block_params_from_jax(t).items()}
    stage_cls = rt.remote(cases.BlockStageActor)
    s0, s1 = (stage_cls.remote(stage_state_dict(whole, i, 1), 1)
              for i in range(2))
    B, L = 2, 16
    xs = [rng.randn(B, L, cfg.d_model).astype(np.float32) for _ in range(3)]
    with InputNode() as inp:
        out = s1.forward.bind(s0.forward.bind(inp))
    dag = out.experimental_compile(max_buffer_size=1 << 20)
    try:
        got = [dag.execute(torch.from_numpy(x), timeout_s=60) for x in xs]
    finally:
        _torn_down(dag)
    for x, y in zip(xs, got):
        assert isinstance(y, torch.Tensor) and y.shape == (B, L, cfg.d_model)
        torch.testing.assert_close(
            y, torch.from_numpy(_jax_two_blocks(trees, x, L)), **STAGE_TOL)
