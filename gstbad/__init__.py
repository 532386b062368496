"""gstbad — a JAX-native media-compute framework.

A from-scratch rebuild of GStreamer gst-plugins-bad's media-compute layer
(reference: /root/reference, gst-plugins-bad 1.19.2) on JAX/XLA/Pallas.

Where the reference runs one C element per streaming thread with ORC SIMD
inner loops, this framework represents an element as a pure function
``process(params, state, batch) -> (state, batch)`` over batched NHWC uint8
frame tensors (video) or [B, S, C] PCM blocks (audio), and compiles a whole
pipeline into a single fused XLA program per frame window.

Package layout
  core/      MediaSpec (caps analog), Element protocol, Pipeline compiler,
             gst-launch-style string parser, test harness, bus messages
  ops/       JAX/Pallas kernels (the ORC-kernel analog)
  elements/  the element families (gaudieffects, coloreffects,
             geometrictransform, bayer, videofilters, audio chain, ...)
  golden/    NumPy transcriptions of the reference C math — the fidelity
             oracle used by tests (SURVEY.md section 4.4)
  models/    the benchmark pipeline graphs from BASELINE.md
  parallel/  jax.sharding mesh helpers (DP over frames, SP over rows)
"""

import jax as _jax

# The reference computes geometry maps in double precision
# (gstgeometrictransform.c:80-128 uses gdouble maps) and carries guint64
# timestamps/accumulators.  Enable x64 so host-side precomputation and
# golden comparisons are exact; hot device paths request explicit
# uint8/int32/float32 dtypes and are unaffected.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from gstbad.core.spec import MediaSpec, VideoFormat, AudioFormat  # noqa: E402
from gstbad.core.element import Element, Property  # noqa: E402
from gstbad.core.registry import register, make, element_names  # noqa: E402
from gstbad.core.pipeline import Pipeline, parse_launch  # noqa: E402

# Importing the element packages registers every element factory.
from gstbad import elements as _elements  # noqa: E402,F401

__all__ = [
    "MediaSpec", "VideoFormat", "AudioFormat",
    "Element", "Property",
    "register", "make", "element_names",
    "Pipeline", "parse_launch",
]
