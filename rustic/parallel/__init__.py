"""Multi-chip scaling: device meshes + shard_map rendering.

The reference is single-device (SURVEY.md §2: no collectives of any
kind exist upstream); this layer is the new capability this build
adds. Paths are embarrassingly parallel, so the design is pure SPMD:

- mesh axes ('px', 'spp'): the pixel batch shards over 'px', the sample
  range shards over 'spp',
- scene arrays are replicated (read-only, small),
- each device integrates its (pixel-shard x sample-shard) block fully
  on its device; the only collective is one psum of film sums over
  'spp' (NCCL on GPUs).
"""

from rustic.parallel.shard import (  # noqa: F401
    make_mesh,
    render_sharded,
    sharded_step,
)
