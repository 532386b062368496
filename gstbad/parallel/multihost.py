"""Multi-host frame feed — the DCN-side ipcpipeline analog
(SURVEY.md §2.6: "multi-host feed is DCN host transfers of
(tensor, MediaSpec, pts) tuples").

In a multi-process JAX job each host holds its slice of a frame window
(e.g. its capture cards' streams); `feed_window` assembles the global
sharded FrameBatch from per-host numpy data with
`jax.make_array_from_process_local_data`, which moves bytes host->device
locally and lets XLA's collectives ride ICI/DCN from there.  The typed
control plane between hosts stays io/ipcpipeline.py — this module is
only the data plane.

Single-process (tests, the virtual-device CPU mesh) degrades to plain
device_put sharding, so the same call works everywhere.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from gstbad.core.frame import FrameBatch
from gstbad.parallel.mesh import _data_spec
from jax.sharding import PartitionSpec as P


def feed_window(mesh: Mesh, local_data, local_pts=None,
                kind: str = "video") -> FrameBatch:
    """Assemble a global FrameBatch from THIS process's local window slice.

    local_data: numpy [B_local, ...] (or {plane: ...}); every process
    must call this collectively with its own slice; B_global =
    B_local * n_processes along the dp axis."""

    def place(x):
        x = jnp.asarray(x) if jax.process_count() == 1 else x
        sharding = NamedSharding(mesh, _data_spec(x.ndim, kind))
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        return jax.make_array_from_process_local_data(sharding, x)

    def place_meta(x):
        sharding = NamedSharding(mesh, P("dp"))
        if jax.process_count() == 1:
            return jax.device_put(jnp.asarray(x), sharding)
        return jax.make_array_from_process_local_data(sharding, x)

    if isinstance(local_data, dict):
        data = {k: place(v) for k, v in local_data.items()}
        b_local = next(iter(local_data.values())).shape[0]
    else:
        data = place(local_data)
        b_local = local_data.shape[0]
    if local_pts is None:
        local_pts = np.zeros(b_local, np.int64)
    return FrameBatch(
        data=data,
        pts=place_meta(np.asarray(local_pts, np.int64)),
        flags=place_meta(np.zeros(b_local, np.int32)),
        valid=place_meta(np.ones(b_local, bool)))
