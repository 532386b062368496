from gstbad.parallel.mesh import (make_mesh, shard_batch, shard_spatial,
                                      pipeline_shardings)
from gstbad.parallel.multihost import feed_window  # noqa: F401
