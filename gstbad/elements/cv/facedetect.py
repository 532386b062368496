"""facedetect / faceblur (ext/opencv/gstfacedetect.cpp, gstfaceblur.cpp)
— Haar-cascade face detection over the REAL OpenCV model files
(/usr/share/opencv4/haarcascades, the references' HAAR_CASCADES_DIR
defaults), evaluated by this repo's cascade engine (io/haarcascade.py
new-format parse + ops/haar.py data-driven scan evaluator).

facedetect (gstfacedetect.cpp:92-105 defaults: scale-factor 1.25,
min-neighbors 3, min-size 30x30, min-stddev 0, updates every-frame):
gray conversion, min-stddev gate (meanStdDev over the full gray frame,
gstfacedetect.cpp:563-575), pyramid detection, a `facedetect` message
per frame carrying the face boxes (x/y/width/height arrays bounded at
MAX_FACES, posted per the updates mode's transition logic,
gstfacedetect.cpp:608-637), and display ellipses with the reference's
per-face color formula cb/cg/cr = 255 - ((i & m) << s)
(gstfacedetect.cpp:717-731; axes h*1.25).

faceblur (gstfaceblur.cpp:71-82 defaults: scale-factor 1.25,
min-neighbors 3, min-size 30x30): each detected face rect gets
blur(11x11) THEN GaussianBlur(11x11, sigma 0) — both, in that order,
like the reference (gstfaceblur.cpp:372-373).

Divergences (documented): detectMultiScale grouping is the engine's
3x3 neighbor-count confirmation + greedy overlap suppression
(cv2 5.0 removed objdetect, no oracle); nose/mouth/eyes sub-detection
runs only when the profile files exist (the reference's mcs_* models
are not shipped in /usr/share/opencv4) and scans the full frame gated
to the reference's per-face ROI boxes rather than re-running inside
the ROI; ellipses rasterize as |r-1| <= eps rings; faceblur blurs the
whole frame once and masks it into the face rects, so ROI-border
reflection reads neighboring pixels instead of reflecting at the rect
edge."""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat
from gstbad.io.haarcascade import parse_cascade
from gstbad.ops import cv as cvops
from gstbad.ops import haar

HAAR_DIR = "/usr/share/opencv4/haarcascades/"
MAX_FACES = 8

UPDATES = ("every-frame", "on-change", "on-face", "none")


def _load(profile: str):
    """Cascade arrays for a profile path, or None when absent/invalid
    (the references post a warning and skip that detector)."""
    if not profile or not os.path.exists(profile):
        return None
    try:
        return haar.compile_arrays(parse_cascade(profile))
    except Exception:  # noqa: BLE001 — unparsable profile = disabled
        return None


def _detect_faces(gray_f32, arrs, scale_factor, min_neighbors,
                  min_w, min_h):
    """[H, W] f32 -> (boxes [MAX_FACES, 4] i32 (x, y, w, h),
    valid [MAX_FACES]).  Confirmed windows (pass + 3x3 count >=
    min_neighbors) across the pyramid, greedy top-score selection with
    center-inside-box suppression."""
    h, w = gray_f32.shape
    scales = haar.detect_multi_scale_arrays(gray_f32, arrs,
                                            scale_factor)
    cand_score = []
    cand_box = []
    for s in scales:
        fw, fh = s["size"]
        if (min_w and fw < min_w) or (min_h and fh < min_h):
            continue
        ok = s["passed"] & (s["counts"] >= min_neighbors)
        ny, nx = ok.shape
        ys = jnp.arange(ny, dtype=jnp.int32)[:, None]
        xs = jnp.arange(nx, dtype=jnp.int32)[None, :]
        f = s["factor"]
        bx = (xs * haar.STRIDE * f).astype(jnp.int32)
        by = (ys * haar.STRIDE * f).astype(jnp.int32)
        score = jnp.where(ok, s["counts"].astype(jnp.float32)
                          + s["score"] * 1e-3, -jnp.inf)
        cand_score.append(score.reshape(-1))
        cand_box.append(jnp.stack([
            jnp.broadcast_to(bx, ok.shape).reshape(-1),
            jnp.broadcast_to(by, ok.shape).reshape(-1),
            jnp.full(ny * nx, fw, jnp.int32),
            jnp.full(ny * nx, fh, jnp.int32)], axis=-1))
    if not cand_score:
        return (jnp.zeros((MAX_FACES, 4), jnp.int32),
                jnp.zeros(MAX_FACES, bool))
    score = jnp.concatenate(cand_score)
    boxes = jnp.concatenate(cand_box)

    def pick(carry, _):
        score, out, valid, k = carry
        i = jnp.argmax(score)
        s_i = score[i]
        box = boxes[i]
        take = jnp.isfinite(s_i)
        out = jnp.where(take, out.at[k].set(box), out)
        valid = jnp.where(take, valid.at[k].set(True), valid)
        # suppress candidates whose center falls inside the taken box
        cx = boxes[:, 0] + boxes[:, 2] // 2
        cy = boxes[:, 1] + boxes[:, 3] // 2
        inside = ((cx >= box[0]) & (cx < box[0] + box[2])
                  & (cy >= box[1]) & (cy < box[1] + box[3]))
        score = jnp.where(take & inside, -jnp.inf, score)
        return (score, out, valid, k + 1), None

    init = (score, jnp.zeros((MAX_FACES, 4), jnp.int32),
            jnp.zeros(MAX_FACES, bool), 0)
    (_, out, valid, _), _ = jax.lax.scan(pick, init, None,
                                         length=MAX_FACES)
    return out, valid


def _ellipse_ring(h, w, cx, cy, ax, ay, thickness):
    """|normalized radius - 1| band ~ cv::ellipse thickness ring."""
    yy = jnp.arange(h, dtype=jnp.float32)[:, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :]
    axf = jnp.maximum(ax.astype(jnp.float32), 1.0)
    ayf = jnp.maximum(ay.astype(jnp.float32), 1.0)
    r = jnp.sqrt(((xx - cx) / axf) ** 2 + ((yy - cy) / ayf) ** 2)
    eps = thickness / (2.0 * jnp.minimum(axf, ayf))
    return jnp.abs(r - 1.0) <= eps


class _CascadeFilter(VideoFilter):
    FORMATS = (VideoFormat.RGB,)

    def _gray(self, data):
        return cvops.rgb2gray_u8(data).astype(jnp.float32)

    def _detect_batch(self, data, arrs, scale_factor, min_neighbors,
                      min_w, min_h):
        return jax.vmap(lambda g: _detect_faces(
            g, arrs, scale_factor, min_neighbors, min_w, min_h)
        )(self._gray(data))


@register
class FaceDetect(_CascadeFilter):
    NAME = "facedetect"
    PROPERTIES = (
        Property("display", bool, True, static=True),
        Property("profile", str,
                 HAAR_DIR + "haarcascade_frontalface_default.xml",
                 static=True),
        Property("nose-profile", str,
                 HAAR_DIR + "haarcascade_mcs_nose.xml", static=True),
        Property("mouth-profile", str,
                 HAAR_DIR + "haarcascade_mcs_mouth.xml", static=True),
        Property("eyes-profile", str,
                 HAAR_DIR + "haarcascade_mcs_eyepair_small.xml",
                 static=True),
        Property("scale-factor", float, 1.25, 1.1, 10.0, static=True),
        Property("min-neighbors", int, 3, 0, None, static=True),
        Property("min-size-width", int, 30, 0, None, static=True),
        Property("min-size-height", int, 30, 0, None, static=True),
        Property("min-stddev", int, 0, 0, 255, static=True),
        Property("updates", str, "every-frame", static=True),
    )

    def prepare(self):
        if self.props["updates"] not in UPDATES:
            raise ValueError(f"facedetect: bad updates "
                             f"{self.props['updates']!r}")
        self._face = _load(self.props["profile"])
        if self._face is None:
            raise ValueError("facedetect: missing faces profile file "
                             f"{self.props['profile']}")
        self._nose = _load(self.props["nose-profile"])
        self._mouth = _load(self.props["mouth-profile"])
        self._eyes = _load(self.props["eyes-profile"])

    def init_state(self, window: int):
        return {"face_detected": jnp.bool_(False)}

    def _sub_boxes(self, gray, arrs, roi, min_w, min_h):
        """First confirmed sub-detection whose center lies in `roi`
        ([4] x,y,w,h), scanning the full frame (divergence noted)."""
        boxes, valid = _detect_faces(gray, arrs, 1.25, 2, min_w, min_h)
        cx = boxes[:, 0] + boxes[:, 2] // 2
        cy = boxes[:, 1] + boxes[:, 3] // 2
        inside = (valid & (cx >= roi[0]) & (cx < roi[0] + roi[2])
                  & (cy >= roi[1]) & (cy < roi[1] + roi[3]))
        any_hit = inside.any()
        first = jnp.argmax(inside)
        return jnp.where(any_hit, boxes[first],
                         jnp.zeros(4, jnp.int32)), any_hit

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        b, h, w, _ = data.shape
        gray = self._gray(data)
        boxes, valid = self._detect_batch(
            data, self._face, self.props["scale-factor"],
            self.props["min-neighbors"], self.props["min-size-width"],
            self.props["min-size-height"])
        if self.props["min-stddev"] > 0:
            mean = jnp.mean(gray, axis=(1, 2), keepdims=False)
            std = jnp.sqrt(jnp.mean(
                (gray - mean[:, None, None]) ** 2, axis=(1, 2)))
            gate = std >= self.props["min-stddev"]
            valid = valid & gate[:, None]

        n_faces = valid.sum(axis=1)
        have = n_faces > 0
        prev = jnp.concatenate([state["face_detected"][None], have[:-1]])
        mode = self.props["updates"]
        if mode == "every-frame":
            post = jnp.ones(b, bool)
        elif mode == "on-change":
            post = have != prev
        elif mode == "on-face":
            post = have
        else:
            post = jnp.zeros(b, bool)

        msgs = {"facedetect": {
            "_emit": post,
            "x": boxes[..., 0], "y": boxes[..., 1],
            "width": boxes[..., 2], "height": boxes[..., 3],
            "n_faces": n_faces}}

        # per-face sub-feature ROIs (gstfacedetect.cpp:652-688)
        for arrs, name, roi_fn in (
            (self._nose, "nose", lambda r: jnp.stack(
                [r[0] + r[2] // 4, r[1] + r[3] // 4,
                 r[2] // 2, r[3] // 2])),
            (self._mouth, "mouth", lambda r: jnp.stack(
                [r[0], r[1] + r[3] // 2, r[2], r[3] // 2])),
            (self._eyes, "eyes", lambda r: jnp.stack(
                [r[0], r[1], r[2], r[3] // 2])),
        ):
            if arrs is None:
                continue
            mw = self.props["min-size-width"] // 8
            mh = self.props["min-size-height"] // 8

            def per_frame(g, face_box, face_ok, arrs=arrs,
                          roi_fn=roi_fn, mw=mw, mh=mh):
                box, hit = self._sub_boxes(g, arrs, roi_fn(face_box),
                                           mw, mh)
                return box, hit & face_ok

            sub, sub_ok = jax.vmap(lambda g, bs, vs: jax.vmap(
                lambda fb, fv: per_frame(g, fb, fv))(bs, vs)
            )(gray, boxes, valid)
            msgs["facedetect"][name + "_x"] = sub[..., 0]
            msgs["facedetect"][name + "_y"] = sub[..., 1]
            msgs["facedetect"][name + "_width"] = sub[..., 2]
            msgs["facedetect"][name + "_height"] = sub[..., 3]
            msgs["facedetect"]["have_" + name] = sub_ok

        out = data
        if self.props["display"]:
            def draw(img, fboxes, fvalid):
                for i in range(MAX_FACES):
                    r = fboxes[i]
                    # the C passes these to cv::Scalar, which
                    # saturate-casts negatives to 0 at draw time
                    cb = max(0, 255 - ((i & 3) << 7))
                    cg = max(0, 255 - ((i & 12) << 5))
                    cr = max(0, 255 - ((i & 48) << 3))
                    wf = r[2].astype(jnp.float32) / 2
                    hf = r[3].astype(jnp.float32) / 2
                    ring = _ellipse_ring(
                        h, w, r[0].astype(jnp.float32) + wf,
                        r[1].astype(jnp.float32) + hf,
                        wf, hf * 1.25, 3.0) & fvalid[i]
                    color = jnp.asarray([cr, cg, cb], jnp.uint8)
                    img = jnp.where(ring[..., None], color[None, None],
                                    img)
                return img
            out = jax.vmap(draw)(data, boxes, valid)

        new_state = {"face_detected": have[-1]}
        return new_state, batch.with_data(out), msgs


@register
class FaceBlur(_CascadeFilter):
    NAME = "faceblur"
    PROPERTIES = (
        Property("profile", str,
                 HAAR_DIR + "haarcascade_frontalface_default.xml",
                 static=True),
        Property("scale-factor", float, 1.25, 1.1, 10.0, static=True),
        Property("min-neighbors", int, 3, 0, None, static=True),
        Property("min-size-width", int, 30, 0, None, static=True),
        Property("min-size-height", int, 30, 0, None, static=True),
    )

    def prepare(self):
        self._face = _load(self.props["profile"])
        if self._face is None:
            raise ValueError("faceblur: missing profile file "
                             f"{self.props['profile']}")

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        b, h, w, _ = data.shape
        boxes, valid = self._detect_batch(
            data, self._face, self.props["scale-factor"],
            self.props["min-neighbors"], self.props["min-size-width"],
            self.props["min-size-height"])
        # blur(11,11) then GaussianBlur(11,11,0) — both, like the
        # reference (gstfaceblur.cpp:372-373)
        blurred = cvops.gaussian_blur_u8(
            cvops.box_blur_u8(data, 11, 11), 11, 11, 0.0)
        yy = jnp.arange(h, dtype=jnp.int32)[:, None]
        xx = jnp.arange(w, dtype=jnp.int32)[None, :]

        def mask_frame(fboxes, fvalid):
            m = jnp.zeros((h, w), bool)
            for i in range(MAX_FACES):
                r = fboxes[i]
                m = m | (fvalid[i] & (yy >= r[1]) & (yy < r[1] + r[3])
                         & (xx >= r[0]) & (xx < r[0] + r[2]))
            return m

        mask = jax.vmap(mask_frame)(boxes, valid)
        out = jnp.where(mask[..., None], blurred, data)
        return state, batch.with_data(out)
