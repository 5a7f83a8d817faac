"""Cross-node compiled-DAG channels on the port: the two cases of
tests/test_dag_cross_node.py on ``ray_tpu_torch.cluster_utils.Cluster``.
Stages live on different nodes; each edge's versions reach the other
node through the node managers' ``channel_publish`` / ``channel_push``
into a mirror channel there, and teardown closes the mirrors
(``channel_close``) so that no channel file of the DAG is left."""

import glob

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode, MultiOutputNode


def _teardown(dag):
    dag.teardown()
    assert set(rt.get(dag._loop_refs, timeout=30)) == {"closed"}
    assert not glob.glob(f"{glob.escape(dag.prefix)}*")


def test_compiled_dag_two_node_pipeline():
    """A 2-node pipeline DAG: stage actors pinned to DIFFERENT nodes;
    edge versions flow through node-manager-pushed channel mirrors."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    n2 = cluster.add_node(num_cpus=2)
    rt.init(address=cluster.address)
    cluster.wait_for_nodes()
    try:
        head_id = cluster.nodes[0].node_id

        @rt.remote(num_cpus=0.5)
        class Stage:
            def __init__(self, k):
                self.k = k

            def apply(self, x):
                return x * 10 + self.k

            def node(self):
                return rt.get_runtime_context()["node_id"]

        s1 = Stage.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                head_id)).remote(1)
        s2 = Stage.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                n2.node_id)).remote(2)
        nodes = rt.get([s1.node.remote(), s2.node.remote()], timeout=60)
        assert nodes[0] != nodes[1], "stages must live on different nodes"

        with InputNode() as inp:
            out = s2.apply.bind(s1.apply.bind(inp))
        dag = out.experimental_compile()
        try:
            # (x*10+1)*10+2
            assert dag.execute(0, timeout_s=60) == 12
            for i in range(10):
                assert dag.execute(i, timeout_s=60) == (i * 10 + 1) * 10 + 2
        finally:
            _teardown(dag)
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_compiled_dag_two_node_multi_consumer():
    """One producer feeds consumers on BOTH nodes; the driver (third
    reader) gets its own mirror of the terminal outputs."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    n2 = cluster.add_node(num_cpus=2)
    rt.init(address=cluster.address)
    cluster.wait_for_nodes()
    try:
        head_id = cluster.nodes[0].node_id

        @rt.remote(num_cpus=0.5)
        class Node:
            def ident(self, x):
                return x

            def add(self, x, k=0):
                return x + k

        prod = Node.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(head_id))).remote()
        c_local = Node.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(head_id))).remote()
        c_remote = Node.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(n2.node_id))).remote()

        with InputNode() as inp:
            mid = prod.ident.bind(inp)
            o1 = c_local.add.bind(mid, k=100)
            o2 = c_remote.add.bind(mid, k=200)
            dag = MultiOutputNode([o1, o2]).experimental_compile()
        try:
            assert dag.execute(5, timeout_s=60) == [105, 205]
            assert dag.execute(7, timeout_s=60) == [107, 207]
        finally:
            _teardown(dag)
    finally:
        rt.shutdown()
        cluster.shutdown()
