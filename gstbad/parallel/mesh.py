"""Device-mesh parallelism — the JAX replacement for the reference's
thread-per-element pipeline parallelism (SURVEY.md section 2.6).

The reference parallelizes by running each element on its own streaming
thread; frames stay sequential.  Here the batch axis IS the parallel axis:
a window of W frames shards over the mesh's `dp` axis (data parallel over
frames), and 4K-class frames can additionally shard rows over `sp`
(spatial parallelism, the CP analog) — XLA inserts the halo exchanges for
the few ops with row-neighborhoods as collective-permutes.  The devices are
joined all to all, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gstbad.core.frame import FrameBatch


def make_mesh(dp: int = 0, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh.  dp=0 means "all remaining devices"."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp == 0:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    arr = np.array(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def _data_spec(ndim: int, kind: str = "video") -> P:
    """PartitionSpec for a frame-data leaf: batch over dp, rows over sp."""
    if ndim >= 3:
        return P("dp", "sp", *([None] * (ndim - 2)))
    if ndim >= 1:
        return P("dp", *([None] * (ndim - 1)))
    return P()


def shard_batch(batch: FrameBatch, mesh: Mesh) -> FrameBatch:
    """Place a FrameBatch on the mesh: frames over dp, rows over sp."""

    def place(x):
        spec = _data_spec(x.ndim)
        return jax.device_put(x, NamedSharding(mesh, spec))

    def place_meta(x):
        return jax.device_put(x, NamedSharding(mesh, P("dp")))

    data = (jax.tree_util.tree_map(place, batch.data)
            if isinstance(batch.data, dict) else place(batch.data))
    return FrameBatch(data=data, pts=place_meta(batch.pts),
                      flags=place_meta(batch.flags),
                      valid=place_meta(batch.valid))


def shard_spatial(x, mesh: Mesh):
    """Shard a single frame's rows over the whole mesh (sp view)."""
    return jax.device_put(x, NamedSharding(mesh, P(None, ("dp", "sp"))))


def pipeline_shardings(mesh: Mesh, example: FrameBatch):
    """(in_shardings, out_shardings)-style pytree of NamedShardings matching
    `shard_batch` placement, for jax.jit arguments."""

    def spec_of(x):
        return NamedSharding(mesh, _data_spec(np.ndim(x)))

    def meta(x):
        return NamedSharding(mesh, P("dp"))

    data = (jax.tree_util.tree_map(spec_of, example.data)
            if isinstance(example.data, dict) else spec_of(example.data))
    return FrameBatch(data=data, pts=meta(example.pts),
                      flags=meta(example.flags), valid=meta(example.valid))
