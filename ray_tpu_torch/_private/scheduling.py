"""Cluster scheduling policies over the node resource view.

Re-design of the reference's two-level scheduler policy layer
(reference: src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:50,
scorer.cc, scheduling_policy.h). Same observable behavior — hybrid
pack-then-spread with a utilization threshold and top-k randomization,
plus SPREAD / NODE_AFFINITY / placement-group policies — implemented as
pure functions over plain dicts so the GCS (actors, placement groups) and
node managers (task spillback) share one code path and the logic is unit
testable with fake node maps, like the reference's scheduler tests.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

EPS = 1e-9

# Resources that exist on every node implicitly.
IMPLICIT_RESOURCES = ("CPU", "memory", "object_store_memory")

# A node's view: {"total": {res: qty}, "available": {res: qty}, "labels": {...},
#                 "alive": bool, "address": str}


def subtract(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def add_back(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


def fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    for k, v in req.items():
        if v > EPS and avail.get(k, 0.0) + EPS < v:
            return False
    return True


def feasible(total: Dict[str, float], req: Dict[str, float]) -> bool:
    """Could this node EVER run the request (ignoring current usage)?"""
    for k, v in req.items():
        if v > EPS and total.get(k, 0.0) + EPS < v:
            return False
    return True


def _utilization(node: Dict, req: Dict[str, float]) -> float:
    """Max fractional utilization across requested-and-present resources
    after hypothetically placing `req` (the reference's scorer)."""
    total, avail = node["total"], node["available"]
    score = 0.0
    for k, cap in total.items():
        if cap <= EPS:
            continue
        used = cap - avail.get(k, 0.0) + req.get(k, 0.0)
        score = max(score, min(1.0, used / cap))
    return score


def hybrid_policy(nodes: Dict[str, Dict], req: Dict[str, float],
                  preferred_node: Optional[str] = None,
                  spread_threshold: float = 0.5,
                  top_k_fraction: float = 0.2,
                  rng: Optional[random.Random] = None) -> Optional[str]:
    """Default policy: prefer the local/preferred node while its utilization
    stays under `spread_threshold`, else pack onto the least-utilized
    feasible nodes, randomizing among the top-k to avoid herding
    (reference: hybrid_scheduling_policy.cc)."""
    rng = rng or random
    if preferred_node is not None:
        node = nodes.get(preferred_node)
        if (node is not None and node.get("alive", True)
                and fits(node["available"], req)
                and _utilization(node, req) < spread_threshold):
            return preferred_node

    candidates: List[Tuple[float, str]] = []
    for nid, node in nodes.items():
        if not node.get("alive", True):
            continue
        if not fits(node["available"], req):
            continue
        candidates.append((_utilization(node, req), nid))
    if not candidates:
        return None
    candidates.sort()
    k = max(1, int(len(candidates) * top_k_fraction))
    # prefer below-threshold nodes among the top-k
    below = [c for c in candidates[:k] if c[0] < spread_threshold]
    pool = below or candidates[:k]
    return rng.choice(pool)[1]


def spread_policy(nodes: Dict[str, Dict], req: Dict[str, float],
                  rng: Optional[random.Random] = None) -> Optional[str]:
    """Least-utilized feasible node (SPREAD scheduling strategy)."""
    best, best_score = None, 2.0
    for nid, node in nodes.items():
        if not node.get("alive", True) or not fits(node["available"], req):
            continue
        s = _utilization(node, req)
        if s < best_score:
            best, best_score = nid, s
    return best


def node_affinity_policy(nodes: Dict[str, Dict], req: Dict[str, float],
                         node_id: str, soft: bool) -> Optional[str]:
    node = nodes.get(node_id)
    if node is not None and node.get("alive", True) and fits(node["available"], req):
        return node_id
    if soft:
        return hybrid_policy(nodes, req)
    return None


def pick_node(nodes: Dict[str, Dict], req: Dict[str, float],
              strategy: str = "DEFAULT",
              preferred_node: Optional[str] = None,
              strategy_args: Optional[Dict] = None) -> Optional[str]:
    strategy_args = strategy_args or {}
    if strategy == "SPREAD":
        return spread_policy(nodes, req)
    if strategy == "NODE_AFFINITY":
        return node_affinity_policy(nodes, req, strategy_args["node_id"],
                                    strategy_args.get("soft", False))
    return hybrid_policy(nodes, req, preferred_node=preferred_node)


def schedule_bundles(nodes: Dict[str, Dict], bundles: Sequence[Dict[str, float]],
                     strategy: str) -> Optional[List[str]]:
    """Placement-group bundle placement (reference:
    src/ray/raylet/scheduling/policy/bundle_scheduling_policy.cc).
    Returns one node id per bundle, or None if infeasible. Works on a copy
    of availability so partial placements don't leak."""
    shadow = {nid: {**n, "available": dict(n["available"])}
              for nid, n in nodes.items() if n.get("alive", True)}

    def place(bundle, allowed=None, forbidden=()):
        order = sorted(shadow.items(), key=lambda kv: _utilization(kv[1], bundle))
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            pass  # least-utilized first = spread
        else:  # PACK: most-utilized first
            order = order[::-1]
        for nid, node in order:
            if allowed is not None and nid not in allowed:
                continue
            if nid in forbidden:
                continue
            if fits(node["available"], bundle):
                subtract(node["available"], bundle)
                return nid
        return None

    placement: List[str] = []
    if strategy == "STRICT_PACK":
        # all bundles on one node
        for nid, node in sorted(shadow.items(),
                                key=lambda kv: _utilization(kv[1], {}), reverse=True):
            avail = dict(node["available"])
            ok = True
            for b in bundles:
                if not fits(avail, b):
                    ok = False
                    break
                subtract(avail, b)
            if ok:
                return [nid] * len(bundles)
        return None
    used: set = set()
    for bundle in bundles:
        forbidden = used if strategy == "STRICT_SPREAD" else ()
        nid = place(bundle, forbidden=forbidden)
        if nid is None:
            return None
        placement.append(nid)
        used.add(nid)
    return placement
