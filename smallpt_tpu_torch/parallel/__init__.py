"""Multi-device rendering over a (tile, sample) mesh of shards (row bands x
sample slices), within one process and across torch.distributed ranks."""

from smallpt_tpu_torch.parallel.binned_shard import ShardedBinnedRenderer
from smallpt_tpu_torch.parallel.shard import make_mesh, render_sharded
from smallpt_tpu_torch.parallel.stream_shard import ShardedStreamingRenderer

__all__ = ["make_mesh", "render_sharded", "ShardedStreamingRenderer",
           "ShardedBinnedRenderer"]
