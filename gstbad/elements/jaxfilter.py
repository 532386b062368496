"""jaxfilter — host arbitrary jittable functions in the pipeline.

The reference's precedent for "a model in the pipeline" is ext/onnx
(onnxobjectdetector running an ONNX session per frame) and the
GstOpencvVideoFilter base; here any jittable fn over the batch tensor slots
into the fused window program directly.
"""

from __future__ import annotations

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register


@register
class JaxFilter(Element):
    """Wrap fn(data) -> data (shape/dtype-preserving by default) or pass
    `spec_fn` to transform the negotiated MediaSpec."""

    NAME = "jaxfilter"

    def __init__(self, fn=None, spec_fn=None, **props):
        super().__init__(**props)
        if fn is None:
            raise ValueError("jaxfilter needs fn=<jittable callable>")
        self._fn = fn
        self._spec_fn = spec_fn

    def negotiate(self, in_spec):
        return self._spec_fn(in_spec) if self._spec_fn else in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(self._fn(batch.data))
