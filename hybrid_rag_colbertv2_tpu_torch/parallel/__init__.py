from .mesh import make_mesh, shard_dense_index  # noqa: F401
from .sharded import ShardedRetriever, make_sharded_cascade  # noqa: F401
