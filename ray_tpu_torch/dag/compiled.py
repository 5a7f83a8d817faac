"""CompiledDAG: static execution over pre-allocated actors + mutable
channels (reference: python/ray/dag/compiled_dag_node.py:549 — compiled
graphs bypass per-call scheduling/serialization; execution schedule:
dag_node_operation.py). Each participating actor runs a long-lived loop
(driven by a built-in actor method) that reads its input channels, applies
the bound methods, and writes output channels; the driver writes the input
channel and reads the terminal channel — the per-call cost is two shm
channel handoffs, no RPC. Every channel file of a compiled DAG is named
``CHANNEL_PREFIX<dag id>_<edge>.<node>`` under /dev/shm; teardown closes
and removes them all."""

from __future__ import annotations

import glob
import os
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.nodes import (ClassMethodNode, DAGNode, InputNode,
                                     MultiOutputNode)
from ray_tpu_torch.experimental.channel import (CHANNEL_PREFIX, Channel,
                                                ChannelClosed, ChannelWriter,
                                                node_local_path, open_wait)


def _topo(root: DAGNode) -> List[DAGNode]:
    order: List[DAGNode] = []
    seen = set()

    def visit(n: DAGNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        for up in n._upstream():
            visit(up)
        order.append(n)

    visit(root)
    return order


class CompiledDAG:
    """Cross-node aware: each edge's channel lives on its PRODUCER's
    node; consumer nodes (and the driver's node, for outputs) receive
    published versions as node-manager-pushed mirrors (reference: NCCL
    channels + PushMutableObject; here the transport is shm locally and
    the node managers' RPC plane across nodes)."""

    def __init__(self, root: DAGNode, max_buffer_size: int = 1 << 20):
        import ray_tpu_torch
        self.root = root
        self.prefix = f"{CHANNEL_PREFIX}{uuid.uuid4().hex[:12]}_"
        nodes = _topo(root)
        self.input_node: Optional[InputNode] = None
        if isinstance(root, MultiOutputNode):
            outputs = root.outputs
        else:
            outputs = [root]

        w = ray_tpu_torch._get_worker()
        driver_node = w.core.node_id
        # actor placement (the GCS actor table knows each actor's node)
        actor_node: Dict[str, str] = {}
        self._actors = {}
        for n in nodes:
            if isinstance(n, ClassMethodNode):
                aid = n.actor._actor_id
                self._actors[aid] = n.actor
                if aid not in actor_node:
                    # compile may race actor creation: wait until the GCS
                    # has placed it (its node decides channel placement)
                    import time as _time
                    deadline = _time.monotonic() + 60.0
                    while True:
                        info = w.gcs_call("get_actor_info", actor_id=aid)
                        if info and info.get("node_id") \
                                and info.get("state") == "ALIVE":
                            actor_node[aid] = info["node_id"]
                            break
                        if info and info.get("state") == "DEAD":
                            raise RuntimeError(
                                f"actor {aid[:12]} died before compile: "
                                f"{info.get('death_cause')}")
                        if _time.monotonic() > deadline:
                            raise RuntimeError(
                                f"actor {aid[:12]} never became ALIVE "
                                f"(state: {info and info.get('state')})")
                        _time.sleep(0.05)

        def node_of(n: DAGNode) -> str:
            if isinstance(n, ClassMethodNode):
                return actor_node[n.actor._actor_id]
            return driver_node       # InputNode: the driver produces

        # per-produced-value reader counts by node; same-actor edges
        # resolve in-process (no channel read), so they don't count
        readers: Dict[int, Dict[str, int]] = {}
        seen_edges = set()
        for n in nodes:
            if isinstance(n, MultiOutputNode):
                continue
            for up in n._upstream():
                if (isinstance(n, ClassMethodNode)
                        and isinstance(up, ClassMethodNode)
                        and n.actor._actor_id == up.actor._actor_id):
                    continue
                if isinstance(n, ClassMethodNode):
                    # an actor's loop reads each input channel ONCE per
                    # iteration no matter how many of its steps consume
                    # it (values cache) — count one reader per actor
                    edge = (n.actor._actor_id, id(up))
                    if edge in seen_edges:
                        continue
                    seen_edges.add(edge)
                by_node = readers.setdefault(id(up), {})
                nn = node_of(n)
                by_node[nn] = by_node.get(nn, 0) + 1
        for out in outputs:
            by_node = readers.setdefault(id(out), {})
            by_node[driver_node] = by_node.get(driver_node, 0) + 1

        # one channel SPEC per produced value: the producer creates its
        # local channel; other reader nodes get pushed mirrors
        self.specs: Dict[int, Dict] = {}
        for n in nodes:
            if isinstance(n, MultiOutputNode):
                continue
            if isinstance(n, InputNode):
                if self.input_node is not None and self.input_node is not n:
                    raise ValueError("only one InputNode supported")
                self.input_node = n
            prod = node_of(n)
            by_node = readers.get(id(n), {})
            self.specs[id(n)] = {
                "path": f"{self.prefix}{len(self.specs)}",
                "max_size": max_buffer_size,
                "producer_node": prod,
                "local_readers": by_node.get(prod, 0),
                "remote": {nid: cnt for nid, cnt in by_node.items()
                           if nid != prod},
            }

        # per-actor step plans, in topological order
        plans: Dict[str, Dict] = {}
        for n in nodes:
            if not isinstance(n, ClassMethodNode):
                continue
            plan = plans.setdefault(n.actor._actor_id, {"steps": []})

            def enc(arg):
                if isinstance(arg, DAGNode):
                    return {"chan": self.specs[id(arg)]}
                return {"const": arg}

            plan["steps"].append({
                "method": n.method_name,
                "args": [enc(a) for a in n.args],
                "kwargs": {k: enc(v) for k, v in n.kwargs.items()},
                "out": self.specs[id(n)],
            })

        # launch the loops (each actor creates its own output channels)
        self._loop_refs = []
        for aid, plan in plans.items():
            handle = self._actors[aid]
            from ray_tpu_torch.actor import ActorMethod
            loop_method = ActorMethod(handle, "__rt_dag_loop__")
            self._loop_refs.append(loop_method.remote(plan["steps"]))

        # driver side: writer for the input edge, readers for outputs
        self._in_writer = None
        if self.input_node is not None:
            self._in_writer = ChannelWriter(self.specs[id(self.input_node)])
        self._out_specs = [self.specs[id(o)] for o in outputs]
        self._out_chans = None   # opened lazily (producers create them)
        self._multi = isinstance(root, MultiOutputNode)
        self._destroyed = False

    def _ensure_out_chans(self, timeout_s: float):
        if self._out_chans is None:
            import ray_tpu_torch
            me = ray_tpu_torch._get_worker().core.node_id
            self._out_chans = [
                open_wait(node_local_path(sp["path"], me), timeout_s)
                for sp in self._out_specs]

    def execute(self, *args, timeout_s: float = 60.0):
        if self._in_writer is not None:
            value = args[0] if len(args) == 1 else args
            self._in_writer.write(value, timeout_s=timeout_s)
        self._ensure_out_chans(timeout_s)
        outs = [c.read(timeout_s=timeout_s) for c in self._out_chans]
        return outs if self._multi else outs[0]

    def teardown(self):
        if self._destroyed:
            return
        self._destroyed = True
        import ray_tpu_torch
        w = ray_tpu_torch._get_worker()
        # close every edge everywhere: local channels + pushed mirrors
        for sp in self.specs.values():
            targets = set(sp["remote"])
            targets.add(sp["producer_node"])
            try:
                w.node_call("channel_close", path=sp["path"],
                            targets=list(targets))
            except Exception:
                pass
        if self._in_writer is not None:
            self._in_writer.close()
        try:
            ray_tpu_torch.get(self._loop_refs, timeout=10)
        except Exception:
            pass
        if self._out_chans:
            for ch in self._out_chans:
                try:
                    ch.destroy()
                except Exception:
                    pass
        for path in glob.glob(f"{glob.escape(self.prefix)}*"):
            try:
                os.unlink(path)
            except OSError:
                pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


def _dag_actor_loop(instance, steps: List[Dict]):
    """Runs inside the actor (executor thread) until channels close.
    Output channels are CREATED here (the producer's node owns the
    channel); input channels are opened with a wait, since a remote
    producer's mirror only appears on this node at its first push."""
    writers: Dict[str, ChannelWriter] = {}
    for step in steps:
        sp = step["out"]
        if sp["path"] not in writers:
            writers[sp["path"]] = ChannelWriter(sp)
    in_chans: Dict[str, Channel] = {}

    from ray_tpu_torch import _get_worker
    me = _get_worker().core.node_id

    def in_chan(sp) -> Channel:
        ch = in_chans.get(sp["path"])
        if ch is None:
            # the mirror only materializes at the producer's first
            # publish, which may be arbitrarily long after compile —
            # wait like a read would
            ch = open_wait(node_local_path(sp["path"], me),
                           timeout_s=3600.0)
            in_chans[sp["path"]] = ch
        return ch

    try:
        while True:
            values: Dict[str, Any] = {}

            def resolve(a):
                if "const" in a:
                    return a["const"]
                path = a["chan"]["path"]
                if path not in values:
                    values[path] = in_chan(a["chan"]).read(timeout_s=3600.0)
                return values[path]

            for step in steps:
                args = [resolve(a) for a in step["args"]]
                kwargs = {k: resolve(v) for k, v in step["kwargs"].items()}
                out = getattr(instance, step["method"])(*args, **kwargs)
                writers[step["out"]["path"]].write(out)
                values[step["out"]["path"]] = out
    except ChannelClosed:
        return "closed"
    except TimeoutError:
        return "timeout"
