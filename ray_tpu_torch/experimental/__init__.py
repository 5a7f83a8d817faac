from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                                ChannelWriter, ReaderView,
                                                node_local_path, open_wait)


def broadcast_object(ref, node_ids):
    """Push `ref`'s object to every node in `node_ids` through the
    binomial broadcast tree (owner-directed; see
    node_manager.h_broadcast_object)."""
    import ray_tpu_torch._private.worker as _w
    if _w.global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    return _w.global_worker.broadcast(ref, node_ids)


def object_locations(refs):
    """Best-effort node ids for locally-known objects (owned refs carry
    their executor-reported location; store-resident objects are local).
    None entries = unknown. Reference: the cached-location plane
    RefBundle/OutputSplitter locality dealing reads."""
    import ray_tpu_torch._private.worker as _w
    if _w.global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    return _w.global_worker.core.object_locations(refs)


__all__ = ["Channel", "ChannelClosed", "ChannelWriter", "ReaderView",
           "broadcast_object", "node_local_path", "object_locations",
           "open_wait"]
