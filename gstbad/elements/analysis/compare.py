"""compare (gst/debugutils/gstcompare.c) + iqa (ext/iqa/iqa.c).

The reference's compare joins two live pads and iqa aggregates N pads.  In
this linear-pipeline rebuild the reference stream is attached to the element
(`set_reference`, or upstream via a `tee`-less A/B harness); the scoring math
is identical: mem/max/ssim methods, luma-weighted SSIM, threshold gating.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.ops import ssim as ssim_ops


def _planes(data, spec):
    """Split a frame batch into component planes [(B, H, W), ...]."""
    if isinstance(data, dict):
        return [data["y"], data["u"], data["v"]], True
    fmt = spec.format
    if fmt == VideoFormat.GRAY8:
        return [data], True
    if fmt == VideoFormat.AYUV:
        return [data[..., 1], data[..., 2], data[..., 3], data[..., 0]], True
    offs = VideoFormat.rgb_offsets(fmt)
    planes = [data[..., offs[0]], data[..., offs[1]], data[..., offs[2]]]
    if VideoFormat.has_alpha(fmt):
        planes.append(data[..., offs[3]])
    return planes, False


class _TwoStreamElement(Element):
    """Base for elements comparing a stream against a reference.

    Two ways to feed the reference, matching the reference's 2-pad model:
    - graph fan-in: `videotestsrc ! cmp.  src2. ! cmp.  compare name=cmp ...`
      (first-connected input = reference pad, like iqa's first sink pad)
    - `set_reference(frames)` for harness-style use.
    """

    N_INPUTS = 2

    def __init__(self, **props):
        super().__init__(**props)
        self._reference: Optional[np.ndarray] = None

    def set_reference(self, frames) -> None:
        """Attach the reference stream (the first-sink-pad analog)."""
        if isinstance(frames, dict):
            self._reference = {k: jnp.asarray(v) for k, v in frames.items()}
        else:
            self._reference = jnp.asarray(frames)

    def negotiate(self, in_spec):
        if isinstance(in_spec, list):
            ref_spec = in_spec[0]
            for spec in in_spec[1:]:
                require(ref_spec.format == spec.format
                        and ref_spec.width == spec.width
                        and ref_spec.height == spec.height,
                        f"{self.NAME}: branch specs differ: "
                        f"{ref_spec} vs {spec}")
            return in_spec[-1]
        return in_spec

    def _split_inputs(self, batch):
        """Returns (reference_data, stream_batch)."""
        if isinstance(batch, list):
            return batch[0].data, batch[-1]
        require(self._reference is not None,
                f"{self.NAME}: set_reference() first or connect two inputs")
        return self._reference, batch


@register
class Compare(_TwoStreamElement):
    """Methods mem/max/ssim (gstcompare.c:57-71); posts per-frame delta
    messages and flags frames under `threshold` (with `upper` semantics:
    upper=true passes when delta >= threshold, gstcompare.c:165-172)."""

    NAME = "compare"
    PROPERTIES = (
        Property("method", str, "mem", static=True),
        Property("threshold", float, 0.0),
        Property("upper", bool, True),
    )

    def process(self, params, state, batch):
        ref, batch = self._split_inputs(batch)
        method = self.props["method"]
        if method == "mem":
            if isinstance(batch.data, dict):
                eq = jnp.ones(batch.batch, bool)
                for k in batch.data:
                    eq &= jnp.all(batch.data[k] == ref[k],
                                  axis=tuple(range(1, batch.data[k].ndim)))
            else:
                eq = jnp.all(batch.data == ref,
                             axis=tuple(range(1, batch.data.ndim)))
            delta = eq.astype(jnp.float64)
        elif method == "max":
            if isinstance(batch.data, dict):
                m = jnp.zeros(batch.batch, jnp.float64)
                for k in batch.data:
                    d = jnp.abs(batch.data[k].astype(jnp.int32)
                                - ref[k].astype(jnp.int32))
                    m = jnp.maximum(m, jnp.max(
                        d, axis=tuple(range(1, d.ndim))).astype(jnp.float64))
                delta = m
            else:
                d = jnp.abs(batch.data.astype(jnp.int32)
                            - ref.astype(jnp.int32))
                delta = jnp.max(d, axis=tuple(range(1, d.ndim))
                                ).astype(jnp.float64)
        elif method == "ssim":
            planes_a, is_yuv = _planes(batch.data, self.out_spec)
            planes_b, _ = _planes(ref, self.out_spec)
            weights = ssim_ops.ssim_weights(len(planes_a), is_yuv)
            delta = sum(w * ssim_ops.ssim_plane(a, b)
                        for w, a, b in zip(weights, planes_a, planes_b))
        else:
            raise ValueError(f"unknown method {method!r}")
        passed = jnp.where(params["upper"],
                           delta >= params["threshold"],
                           delta <= params["threshold"])
        msgs = {"delta": {"delta": delta, "passed": passed}}
        return state, batch, msgs


@register
class Iqa(_TwoStreamElement):
    """iqa (ext/iqa/iqa.c): N-input aggregator — the first input is the
    reference, every other input is scored against it per frame
    (aggregate_frames, iqa.c:336-400); the IQA message carries one dssim
    per pad (iqa.c:48-56,392-399).  Optionally writes the SSIM map into
    the output frame (do_dssim, iqa.c:195-290) and flags frames whose
    dssim exceeds ssim-error-threshold (iqa.c:265-275).

    DSSIM is the true multiscale metric (ops/dssim.py, the kornelski/dssim
    algorithm the reference links: Lab-pyramid MS-SSIM, score = 1/ssim - 1,
    0 = identical); AYUV inputs are matrixed to RGB first like the
    reference's RGBA-only dssim path (iqa.c:248-258).  The in-tree
    single-scale SSIM oracle is still reported in the `ssim` field."""

    NAME = "iqa"
    PROPERTIES = (
        Property("do-dssim", bool, True),
        Property("ssim-error-threshold", float, 0.0),
        Property("mode", str, "dssim", static=True),
        Property("output-map", bool, False, static=True),
    )

    def _score(self, data, ref):
        planes_a, is_yuv = _planes(data, self.out_spec)
        planes_b, _ = _planes(ref, self.out_spec)
        weights = ssim_ops.ssim_weights(len(planes_a), is_yuv)
        return sum(w * ssim_ops.ssim_plane(a, b)
                   for w, a, b in zip(weights, planes_a, planes_b))

    def _as_rgb(self, data):
        """u8 RGB view + offsets for the dssim path; AYUV goes through the
        fixed-point YCbCr->RGB matrix, GRAY8/planar luma replicates."""
        import jax.numpy as jnp
        fmt = self.out_spec.format
        if fmt in VideoFormat._RGB_OFFSETS:
            offs = VideoFormat._RGB_OFFSETS[fmt]
            return data, (offs[0], offs[1], offs[2])
        if fmt == VideoFormat.AYUV:
            from gstbad.ops.pointops import _apply_matrix, _YCBCR2RGB
            y = data[..., 1].astype(jnp.int64)
            u = data[..., 2].astype(jnp.int64)
            v = data[..., 3].astype(jnp.int64)
            r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
            rgb = jnp.stack([jnp.clip(r, 0, 255), jnp.clip(g, 0, 255),
                             jnp.clip(b, 0, 255)], -1).astype(jnp.uint8)
            return rgb, (0, 1, 2)
        plane = data["y"] if isinstance(data, dict) else data
        if plane.ndim == 3:
            return jnp.repeat(plane[..., None], 3, axis=-1), (0, 1, 2)
        return None, None

    def process(self, params, state, batch):
        import jax.numpy as jnp
        from gstbad.ops import dssim as dssim_ops

        if isinstance(batch, list):
            ref, streams = batch[0].data, batch[1:]
        else:
            ref, one = self._split_inputs(batch)
            streams = [one]
        thr = params["ssim-error-threshold"]
        fields = {}
        exceeded = None
        ref_rgb, offs = self._as_rgb(ref)
        fmap = None
        for i, sb in enumerate(streams):
            ssim = self._score(sb.data, ref)
            if self.props["do-dssim"] and ref_rgb is not None:
                cmp_rgb, _ = self._as_rgb(sb.data)
                dssim, m = dssim_ops.dssim_rgb(cmp_rgb, ref_rgb, offs)
                if i == 0:
                    fmap = m
            else:
                dssim = (1.0 - ssim) / 2.0
            exc = (thr > 0.0) & (dssim > thr)
            exceeded = exc if exceeded is None else (exceeded | exc)
            if i == 0:  # first compared pad keeps the flat field names
                fields.update({"dssim": dssim, "ssim": ssim})
            fields[f"dssim-pad-{i + 1}"] = dssim
        fields["exceeded"] = exceeded
        out = streams[0]
        if self.props["output-map"] and not isinstance(out.data, dict):
            if fmap is not None:
                mp = jnp.clip(jnp.round(jnp.clip(fmap, 0, 1) * 255),
                              0, 255).astype(jnp.uint8)
                ch = 1 if self.out_spec.format == VideoFormat.AYUV else 0
                out = out.with_data(out.data.at[..., ch].set(mp))
            elif self.out_spec.format == VideoFormat.AYUV:
                y_a, y_b = out.data[..., 1], ref[..., 1]
                mp = ssim_ops.ssim_map(y_a, y_b)
                out = out.with_data(out.data.at[..., 1].set(mp))
        return state, out, {"IQA": fields}
