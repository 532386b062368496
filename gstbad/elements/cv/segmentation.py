"""segmentation element (ext/opencv/gstsegmentation.cpp).

Per-pixel streaming fg/bg models over YCrCb, one `lax.scan` over the
window's frame axis with the model arrays as the carry, so multi-frame
windows stay one fused XLA program.  Methods (gstsegmentation.cpp:114-119):

- ``codebook``: the O'Reilly codebook printed in the reference source
  (learning phase of 30 frames, then re-learn every 1/learning-rate
  frames), followed by the 3x3 open/close mask cleanup.
- ``mog``: Stauffer-Grimson mixture (KadewTraKuPong & Bowden 2001).
- ``mog2``: Zivkovic's adaptive GMM — transcription validated bit-exact
  against cv2's BackgroundSubtractorMOG2 (the exact library call the
  reference makes, gstsegmentation.cpp:772).

Output fidelity quirk (gstsegmentation.cpp:440-453): in test-mode the
reference merges [gray2rgb(mask), mask] back into the 4-channel frame, so
every output channel is the mask.  WITHOUT test-mode it pushes the mask as
a FIFTH channel into cv::merge, which reallocates the destination Mat
instead of writing the mapped GstBuffer — the output frame is left
untouched.  Both behaviors are reproduced; the non-reference
``mask-to-alpha`` property opts into what the code comment *says* it does
("copy the fg/bg to the alpha channel") for users who want the mask.

Known divergences (documented): the codebook keeps at most
ops/segmentation.CB_CAP codewords per pixel (the reference reallocs
unboundedly); the post-cleanup approxPolyDP level-1 contour smoothing is
not reproduced (the contour AREA filter itself is a provable no-op at the
hard-coded perimScale=10000 — see golden/segmentation.morph_open_close);
``mog`` has no cv2 oracle in this environment (bgsegm is absent) and
implements the published algorithm, not opencv_contrib's float ordering.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat
from gstbad.golden.segmentation import CB_LEARN_FRAMES
from gstbad.ops import segmentation as segops


@register
class Segmentation(VideoFilter):
    NAME = "segmentation"
    FORMATS = (VideoFormat.RGBA,)
    PROPERTIES = (
        Property("method", str, "mog2", static=True,
                 doc="codebook | mog | mog2 (default mog2, "
                     "gstsegmentation.cpp:122)"),
        Property("test-mode", bool, False, static=True),
        Property("learning-rate", float, 0.01, 0.0, 1.0,
                 controllable=True),
        Property("mask-to-alpha", bool, False, static=True,
                 doc="non-reference: write the mask into the alpha "
                     "channel instead of reproducing the 5-channel "
                     "merge passthrough quirk"),
    )

    def prepare(self):
        method = self.props["method"]
        if method not in ("codebook", "mog", "mog2"):
            raise ValueError(
                f"segmentation: unknown method {method!r} "
                "(codebook | mog | mog2)")
        # the reference freezes the codebook cadence at caps time from the
        # property value (gstsegmentation.cpp:326)
        lr = max(float(self.props["learning-rate"]), 1e-9)
        self._learning_interval = max(int(1.0 / lr), 1)

    def init_state(self, window: int):
        spec = self.out_spec
        h, w = spec.height, spec.width
        method = self.props["method"]
        if method == "mog2":
            st = segops.mog2_new_state(h, w)
        elif method == "mog":
            st = segops.mog_new_state(h, w)
        else:
            st = segops.codebook_new_state(h, w)
        st["framecount"] = jnp.zeros((), jnp.int32)
        return st

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b = img.shape[0]
        method = self.props["method"]
        ycc = segops.rgb2ycrcb_u8(img[..., :3])
        alphas = jnp.broadcast_to(
            jnp.asarray(params["learning-rate"], jnp.float32), (b,))
        fc0 = state["framecount"]
        model0 = {k: v for k, v in state.items() if k != "framecount"}

        if method == "codebook":
            interval = self._learning_interval

            def step(carry, inp):
                model, fc = carry
                ycc_t, _ = inp
                fc = fc + 1                      # gstsegmentation.cpp:361
                learning = fc < CB_LEARN_FRAMES
                cadence = (~learning) & (fc % interval == 0)
                model = segops.codebook_update(model, ycc_t,
                                               learning | cadence)
                mask = jnp.where(learning,
                                 jnp.zeros(ycc_t.shape[:2], jnp.uint8),
                                 segops.codebook_diff(model, ycc_t))
                return (model, fc), mask

            (model, fc), masks = lax.scan(step, (model0, fc0),
                                          (ycc, alphas))
            masks = segops.morph_open_close(masks)
        else:
            frame_fn = (segops.mog2_frame if method == "mog2"
                        else segops.mog_frame)

            def step(carry, inp):
                model, fc = carry
                ycc_t, alpha = inp
                model, mask = frame_fn(model, ycc_t, alpha)
                return (model, fc + 1), mask

            (model, fc), masks = lax.scan(step, (model0, fc0),
                                          (ycc, alphas))

        model["framecount"] = fc
        if self.props["test-mode"]:
            out = jnp.broadcast_to(masks[..., None], masks.shape + (4,))
        elif self.props["mask-to-alpha"]:
            out = img.at[..., 3].set(masks)
        else:
            out = img                    # the 5-channel merge quirk
        return model, batch.with_data(out)
