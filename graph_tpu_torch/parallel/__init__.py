"""Multi-device paths: a mesh of devices, the collectives joining its
shards, the ragged halo exchange and the sharded PageRank, WCC, SSSP and
triangle count (counterpart of ``graph_tpu.parallel``).

One process drives a list of per-shard tensors, each on its shard's
device; ``use_mesh(Mesh([dev] * k))`` runs the sharded paths with k
shards on one device.
"""

from graph_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    get_default_mesh,
    set_default_mesh,
    use_mesh,
)
from graph_tpu_torch.parallel.pagerank import (
    ShardedPullGraph,
    page_rank_sharded,
    shard_graph,
)
from graph_tpu_torch.parallel.sssp import shard_weighted_graph, sssp_sharded
from graph_tpu_torch.parallel.wcc import shard_hook_graph, wcc_sharded

__all__ = [
    "make_mesh",
    "get_default_mesh",
    "set_default_mesh",
    "use_mesh",
    "ShardedPullGraph",
    "shard_graph",
    "page_rank_sharded",
    "shard_hook_graph",
    "wcc_sharded",
    "shard_weighted_graph",
    "sssp_sharded",
]
