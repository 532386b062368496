"""Camera — the camerabin2 capture-orchestration analog
(gst/camerabin2/gstcamerabin2.c).

The reference is a bin coordinating a camera source with two capture
modes: MODE_IMAGE (start-capture grabs one image to `location`, posts an
"image-done" element message, gstcamerabin2.c:46-49,333-380) and
MODE_VIDEO (start-capture/stop-capture bracket a recording).  `location`
is a printf pattern indexed by capture count; digital zoom sits in the
source path (gstdigitalzoom.c — our digitalzoom element).

Here Camera owns a source pipeline (any launch string) with a digitalzoom
stage, steps it window-by-window, and writes PNM snapshots / y4m
recordings through the io layer.  Messages post on the pipeline bus.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from gstbad.core.bus import Message
from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import parse_launch
from gstbad.core.spec import VideoFormat

MODE_IMAGE = 1  # gstcamerabin2.c MODE_IMAGE / MODE_VIDEO enum
MODE_VIDEO = 2

# -- GstPhotography interface model (gst-libs/gst/interfaces/photography.h)

# GstPhotographyCaps bits (photography.h:324-343)
CAPS_NONE = 0
CAPS_EV_COMP = 1 << 0
CAPS_ISO_SPEED = 1 << 1
CAPS_WB_MODE = 1 << 2
CAPS_TONE = 1 << 3
CAPS_SCENE = 1 << 4
CAPS_FLASH = 1 << 5
CAPS_ZOOM = 1 << 6
CAPS_FOCUS = 1 << 7
CAPS_APERTURE = 1 << 8
CAPS_EXPOSURE = 1 << 9
CAPS_SHAKE = 1 << 10
CAPS_WHITE_BALANCE = 1 << 11
CAPS_NOISE_REDUCTION = 1 << 12
CAPS_FLICKER_REDUCTION = 1 << 13

# GstPhotographyWbMode (photography.h:159-170) -> (v-gain, u-gain):
# color-difference channel gains of the adjust stage.  V carries R-Y and
# U carries B-Y, so a warm light correction (tungsten) damps V / boosts U.
WB_MODES = {
    "auto": (1.0, 1.0),
    "daylight": (1.0, 1.0),
    "cloudy": (1.08, 0.95),
    "sunset": (1.2, 0.85),
    "tungsten": (0.8, 1.25),
    "fluorescent": (0.9, 1.1),
    "manual": (1.0, 1.0),
    "warm-fluorescent": (0.85, 1.15),
    "shade": (1.12, 0.9),
}

# GstPhotographyColorToneMode subset wired to compute (photography.h:198)
TONE_MODES = ("normal", "sepia", "negative", "grayscale", "solarize")

# GstPhotographySceneMode (photography.h:256-279): presets of the other
# options ("Each mode contains preset GstPhotography options")
SCENE_PRESETS = {
    "manual": {},
    "auto": {},
    "night": {"ev": 1.0, "iso": 800},
    "sport": {"iso": 400},
    "action": {"iso": 400},
    "landscape": {"wb": "daylight"},
    "portrait": {"ev": 0.3},
    "closeup": {},
    "sunset": {"wb": "sunset"},
    "snow": {"ev": -0.7},
    "beach": {"ev": -0.5},
    "theatre": {"ev": 0.7, "iso": 400},
    "fireworks": {"ev": -1.0},
    "party": {"ev": 0.5, "iso": 400},
    "candlelight": {"wb": "tungsten", "ev": 0.5},
    "barcode": {"tone": "grayscale"},
    "night-portrait": {"ev": 1.0, "iso": 800},
    "steady-photo": {},
    "backlight": {"ev": 0.7},
    "flowers": {},
    "ar": {},
    "hdr": {},
}

FLASH_MODES = ("auto", "off", "on", "fill-in", "red-eye")
FOCUS_MODES = ("auto", "macro", "portrait", "infinity", "hyperfocal",
               "extended", "continuous-normal", "continuous-extended",
               "manual")
NOISE_REDUCTION = ("bayer", "ycc", "temporal", "fixed", "extra")
FLICKER_MODES = ("off", "50hz", "60hz", "auto")

# GstPhotographyFocusStatus (photography.h:306-312)
FOCUS_STATUS_NONE = 0
FOCUS_STATUS_RUNNING = 1
FOCUS_STATUS_FAIL = 2
FOCUS_STATUS_SUCCESS = 3


class _PhotoAdjust(Element):
    """The photography properties as a compute stage in the source path
    (the interface's device implementations live in sys/ drivers; here
    ev/iso/wb/tone act on the frames themselves).  AYUV/GRAY8:
    luma gain = 2^ev * iso_gain, chroma difference channels scaled by
    the wb gains; tone = normal|sepia|negative|grayscale|solarize.
    Dynamic params — changes do not recompile."""

    NAME = "photo-adjust"
    KIND = "filter"
    PROPERTIES = (
        Property("ev", float, 0.0, -2.5, 2.5),
        Property("iso-gain", float, 1.0, 0.125, 16.0),
        Property("wb-v-gain", float, 1.0, 0.25, 4.0),
        Property("wb-u-gain", float, 1.0, 0.25, 4.0),
        Property("tone", int, 0, 0, len(TONE_MODES) - 1),
    )

    def _luma(self, y, params):
        g = jnp.exp2(params["ev"].astype(jnp.float64)) \
            * params["iso-gain"].astype(jnp.float64)
        tone = params["tone"]
        yf = y.astype(jnp.float64) * g
        yf = jnp.clip(jnp.round(yf), 0, 255)
        neg = 255.0 - yf
        sol = jnp.where(yf < 128, yf, 255.0 - yf)  # invert above mid
        yf = jnp.where(tone == 2, neg, yf)
        yf = jnp.where(tone == 4, sol, yf)
        return yf.astype(jnp.uint8)

    def _chroma(self, u, v, params):
        ug = params["wb-u-gain"].astype(jnp.float64)
        vg = params["wb-v-gain"].astype(jnp.float64)
        tone = params["tone"]
        uf = (u.astype(jnp.float64) - 128.0) * ug + 128.0
        vf = (v.astype(jnp.float64) - 128.0) * vg + 128.0
        # sepia: fixed warm chroma; grayscale: neutral chroma;
        # negative mirrors the color difference channels
        uf = jnp.where(tone == 1, 114.0, uf)
        vf = jnp.where(tone == 1, 144.0, vf)
        uf = jnp.where(tone == 3, 128.0, uf)
        vf = jnp.where(tone == 3, 128.0, vf)
        uf = jnp.where(tone == 2, 256.0 - uf, uf)
        vf = jnp.where(tone == 2, 256.0 - vf, vf)
        u8 = jnp.clip(jnp.round(uf), 0, 255).astype(jnp.uint8)
        v8 = jnp.clip(jnp.round(vf), 0, 255).astype(jnp.uint8)
        return u8, v8

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        fmt = self.in_spec.format
        if isinstance(data, dict):
            out = dict(data)
            out["y"] = self._luma(data["y"], params)
            if "u" in data and "v" in data:
                out["u"], out["v"] = self._chroma(data["u"], data["v"],
                                                  params)
            return state, batch.replace(data=out)
        if fmt == VideoFormat.AYUV:
            y = self._luma(data[..., 1], params)
            u, v = self._chroma(data[..., 2], data[..., 3], params)
            out = jnp.stack([data[..., 0], y, u, v], axis=-1)
            return state, batch.replace(data=out, word=None,
                                        word_base=None)
        if fmt == VideoFormat.GRAY8:
            return state, batch.replace(data=self._luma(data, params))
        # RGB formats: the luma gain applies per channel (wb acts on
        # R / B directly via the v/u gains)
        r_off, g_off, b_off, x_off = VideoFormat.rgb_offsets(fmt)
        g = (jnp.exp2(params["ev"].astype(jnp.float64))
             * params["iso-gain"].astype(jnp.float64))
        f = data.astype(jnp.float64) * g
        f = f.at[..., r_off].mul(params["wb-v-gain"].astype(jnp.float64))
        f = f.at[..., b_off].mul(params["wb-u-gain"].astype(jnp.float64))
        out = jnp.clip(jnp.round(f), 0, 255).astype(jnp.uint8)
        if x_off is not None:
            out = out.at[..., x_off].set(data[..., x_off])
        return state, batch.replace(data=out, word=None, word_base=None)


class Camera:
    def __init__(self, source: str = "videotestsrc pattern=bars "
                 "width=320 height=240 format=AYUV",
                 mode: int = MODE_IMAGE,
                 location: Optional[str] = None,
                 zoom: float = 1.0, window: int = 4,
                 post_previews: bool = False,
                 preview_width: Optional[int] = None,
                 preview_height: Optional[int] = None):
        self.mode = mode
        # DEFAULT location patterns: img_%d / vid_%d (gstcamerabin2.c)
        self.location = location or ("img_%d.pnm" if mode == MODE_IMAGE
                                     else "vid_%d.y4m")
        self.window = window
        self._capture_index = 0
        self._recording = None  # list of plane dicts while MODE_VIDEO runs
        # viewfinder branch (gstcamerabin2.c:102: the bin tees into
        # viewfinder + capture + preview branches; the viewfinder gets the
        # stream in EVERY mode, captures or not)
        self._viewfinder = None
        # post-previews / preview-caps (gstcamerabin2.c:713-756): one
        # preview-image element message per capture, in both modes
        self.post_previews = post_previews
        self.preview_size = ((preview_width, preview_height)
                             if preview_width and preview_height else None)
        self.pipeline = parse_launch(
            f"{source} ! digitalzoom name=zoom zoom={zoom} "
            f"! fakesink name=vfsink")
        # GstPhotography adjust stage in the source path (interface
        # properties act on the frames, not dead config)
        self._photo = _PhotoAdjust()
        self.pipeline.insert_before("vfsink", self._photo, "photo")
        self.pipeline.negotiate()
        self._zoom_el = self.pipeline.get_by_name("zoom")
        # photography state (property analog of photography.h:84-109)
        self._ev = 0.0
        self._iso = 0                       # 0 = auto
        self._wb_mode = "auto"
        self._tone_mode = "normal"
        self._scene_mode = "manual"
        self._flash_mode = "auto"
        self._focus_mode = "auto"
        self._noise_reduction = 0
        self._flicker_mode = "off"
        self._exposure_mode = "auto"
        self._exposure_time = 0             # us; 0 = auto
        self._aperture = 0                  # 0 = auto
        self._lens_focus = 0.0
        self._color_temperature = 5000

    @property
    def bus(self):
        return self.pipeline.bus

    # -- GstPhotography interface (gst-libs/gst/interfaces/photography.h).
    # The set_* methods return gboolean like gst_photography_set_*; the
    # capability probe reports which ones this camera implements.

    def get_capabilities(self) -> int:
        """gst_photography_get_capabilities (photography.h:324-343)."""
        return (CAPS_EV_COMP | CAPS_ISO_SPEED | CAPS_WB_MODE | CAPS_TONE
                | CAPS_SCENE | CAPS_FLASH | CAPS_ZOOM | CAPS_FOCUS
                | CAPS_EXPOSURE | CAPS_NOISE_REDUCTION
                | CAPS_FLICKER_REDUCTION)

    def set_ev_compensation(self, ev: float) -> bool:
        """EV steps map to a 2^ev luma gain in the adjust stage."""
        if not -2.5 <= ev <= 2.5:
            return False
        self._ev = float(ev)
        self._photo.set_property("ev", self._ev)
        return True

    def get_ev_compensation(self) -> float:
        return self._ev

    def set_iso_speed(self, iso: int) -> bool:
        """ISO 0 = auto (unity gain); manual ISO applies iso/100 analog
        gain (the ISO 100 base sensitivity convention)."""
        if iso < 0:
            return False
        self._iso = int(iso)
        gain = 1.0 if iso == 0 else max(0.125, min(16.0, iso / 100.0))
        self._photo.set_property("iso-gain", gain)
        return True

    def get_iso_speed(self) -> int:
        return self._iso

    def set_white_balance_mode(self, mode: str) -> bool:
        if mode not in WB_MODES:
            return False
        self._wb_mode = mode
        vg, ug = WB_MODES[mode]
        self._photo.set_property("wb-v-gain", vg)
        self._photo.set_property("wb-u-gain", ug)
        return True

    def get_white_balance_mode(self) -> str:
        return self._wb_mode

    def set_color_tone_mode(self, mode: str) -> bool:
        if mode not in TONE_MODES:
            return False
        self._tone_mode = mode
        self._photo.set_property("tone", TONE_MODES.index(mode))
        return True

    def get_color_tone_mode(self) -> str:
        return self._tone_mode

    def set_scene_mode(self, mode: str) -> bool:
        """Scene modes preset the other options (photography.h:256:
        'Each mode contains preset GstPhotography options')."""
        if mode not in SCENE_PRESETS:
            return False
        self._scene_mode = mode
        preset = SCENE_PRESETS[mode]
        if "ev" in preset:
            self.set_ev_compensation(preset["ev"])
        if "iso" in preset:
            self.set_iso_speed(preset["iso"])
        if "wb" in preset:
            self.set_white_balance_mode(preset["wb"])
        if "tone" in preset:
            self.set_color_tone_mode(preset["tone"])
        return True

    def get_scene_mode(self) -> str:
        return self._scene_mode

    def set_flash_mode(self, mode: str) -> bool:
        if mode not in FLASH_MODES:
            return False
        self._flash_mode = mode
        return True

    def get_flash_mode(self) -> str:
        return self._flash_mode

    def set_focus_mode(self, mode: str) -> bool:
        if mode not in FOCUS_MODES:
            return False
        self._focus_mode = mode
        return True

    def get_focus_mode(self) -> str:
        return self._focus_mode

    def set_autofocus(self, on: bool) -> None:
        """gst_photography_set_autofocus: posts the AUTOFOCUS_DONE
        element message (photography.h:48-65) — there is no physical
        lens, so focusing reports success immediately."""
        if on:
            self.bus.post(Message(
                "camera", "autofocus-done", 0,
                {"focus-status": FOCUS_STATUS_SUCCESS}))

    def set_noise_reduction(self, mask: int) -> bool:
        """Bitmask of NOISE_REDUCTION kinds (photography.h:135-142);
        stored config — the raw sensor chain this would steer (bayer NR)
        is the bayer2rgb element's concern."""
        if mask < 0 or mask >= (1 << len(NOISE_REDUCTION)):
            return False
        self._noise_reduction = int(mask)
        return True

    def get_noise_reduction(self) -> int:
        return self._noise_reduction

    def set_flicker_mode(self, mode: str) -> bool:
        if mode not in FLICKER_MODES:
            return False
        self._flicker_mode = mode
        return True

    def get_flicker_mode(self) -> str:
        return self._flicker_mode

    def set_exposure_mode(self, mode: str) -> bool:
        if mode not in ("auto", "manual"):
            return False
        self._exposure_mode = mode
        return True

    def get_exposure_mode(self) -> str:
        return self._exposure_mode

    def set_exposure_time(self, us: int) -> bool:
        if us < 0:
            return False
        self._exposure_time = int(us)
        return True

    def get_exposure_time(self) -> int:
        return self._exposure_time

    def set_aperture(self, aperture: int) -> bool:
        if not 0 <= aperture <= 255:
            return False
        self._aperture = int(aperture)
        return True

    def get_aperture(self) -> int:
        return self._aperture

    def set_lens_focus(self, focus: float) -> bool:
        if self._focus_mode != "manual":
            return False                   # photography.h:411 lens-focus
        self._lens_focus = float(focus)
        return True

    def get_lens_focus(self) -> float:
        return self._lens_focus

    def set_color_temperature(self, kelvin: int) -> bool:
        """Manual wb color temperature: maps onto the chroma gains
        around the 5000K daylight neutral."""
        if not 1000 <= kelvin <= 20000:
            return False
        self._color_temperature = int(kelvin)
        # warmer light (lower K) needs a cooling correction: damp V,
        # boost U — linear around neutral, clamped to the gain range
        delta = (5000 - kelvin) / 5000.0
        self._photo.set_property(
            "wb-v-gain", float(np.clip(1.0 - 0.4 * delta, 0.25, 4.0)))
        self._photo.set_property(
            "wb-u-gain", float(np.clip(1.0 + 0.4 * delta, 0.25, 4.0)))
        self._wb_mode = "manual"
        return True

    def get_color_temperature(self) -> int:
        return self._color_temperature

    @property
    def zoom(self) -> float:
        return self._zoom_el.props["zoom"]

    @zoom.setter
    def zoom(self, value: float) -> None:
        self._zoom_el.props["zoom"] = float(value)

    def _next_location(self) -> str:
        loc = self.location
        out = loc % self._capture_index if "%" in loc else loc
        self._capture_index += 1
        return out

    def set_viewfinder(self, callback) -> None:
        """Attach the viewfinder sink: `callback(frames, spec)` receives
        every pulled window (the vfbin branch analog)."""
        self._viewfinder = callback

    def run_viewfinder(self, n_windows: int = 1) -> None:
        """Pump preview frames with no capture active — the reference
        pipeline runs the viewfinder branch as soon as it is PLAYING,
        before/between captures."""
        for _ in range(n_windows):
            self._pull()

    @property
    def idle(self) -> bool:
        """The `idle` property (gstcamerabin2.c): no capture running."""
        return self._recording is None

    @property
    def ready_for_capture(self) -> bool:
        return self.mode == MODE_IMAGE or self._recording is None

    def _frame_of(self, batch):
        valid = np.asarray(batch.valid)
        idx = int(np.argmax(valid)) if valid.any() else 0
        if isinstance(batch.data, dict):
            return np.asarray(batch.data["y"])[idx]
        return np.asarray(batch.data)[idx]

    def _post_preview(self, frame: np.ndarray, location: str) -> None:
        """preview-image element message (gstcamerabin2.c:58-60); the
        preview-caps rescale is nearest-neighbor here (the reference
        builds a videoscale preview pipeline)."""
        if not self.post_previews:
            return
        img = frame
        if self.preview_size is not None:
            pw, ph = self.preview_size
            ys = (np.arange(ph) * img.shape[0] // ph)
            xs = (np.arange(pw) * img.shape[1] // pw)
            img = img[ys][:, xs]
        self.bus.post(Message("camerabin", "preview-image", 0,
                              {"buffer": img, "location": location}))

    def _pull(self):
        outs = self.pipeline.run(n_frames=self.window, window=self.window)
        batches = outs if isinstance(outs, list) else outs[0]
        if self._viewfinder is not None:
            for b in batches:
                self._viewfinder(b, self.pipeline.out_spec)
        return batches

    def start_capture(self) -> Optional[str]:
        """MODE_IMAGE: grab one frame to the next location, post
        image-done.  MODE_VIDEO: begin accumulating frames."""
        if self.mode == MODE_IMAGE:
            batches = self._pull()
            frame = self._frame_of(batches[0])
            loc = self._next_location()
            self._write_image(frame, loc)
            self._post_preview(frame, loc)
            self.bus.post(Message("camerabin", "image-done", 0,
                                  {"filename": loc}))
            return loc
        self._recording = []
        # video mode posts its preview at capture start
        # (gstcamerabin2.c:33 "Post preview images for each capture
        # (video and image)")
        if self.post_previews:
            batches = self._pull()
            self._post_preview(self._frame_of(batches[0]),
                               self.location % self._capture_index
                               if "%" in self.location else self.location)
            self.step_batches(batches)
        return None

    def step(self) -> None:
        """MODE_VIDEO: advance one window while recording."""
        if self._recording is None:
            raise RuntimeError("camera: start_capture first")
        self.step_batches(self._pull())

    def step_batches(self, batches) -> None:
        for b in batches:
            valid = np.asarray(b.valid)
            data = b.data
            if isinstance(data, dict):
                self._recording.append(
                    {k: np.asarray(v)[valid] for k, v in data.items()})
            else:
                self._recording.append({"p": np.asarray(data)[valid]})

    def stop_capture(self) -> Optional[str]:
        """MODE_VIDEO: finish the recording, write it, post video-done."""
        if self.mode != MODE_VIDEO or self._recording is None:
            return None
        loc = self._next_location()
        spec = self.pipeline.out_spec
        frames = self._recording
        self._recording = None
        if not frames:
            return None
        merged = {k: np.concatenate([f[k] for f in frames])
                  for k in frames[0]}
        if spec.format == VideoFormat.I420:
            from gstbad.io import y4m
            y4m.write_y4m(loc, spec, merged)
        else:
            merged["p" if "p" in merged else "y"].tofile(loc)
        self.bus.post(Message("camerabin", "video-done", 0,
                              {"filename": loc}))
        return loc

    def _write_image(self, frame: np.ndarray, loc: str) -> None:
        from gstbad.io import pnm
        spec = self.pipeline.out_spec
        if frame.ndim == 3 and frame.shape[-1] == 4:
            if spec.format == VideoFormat.AYUV:
                # quick view: write luma; full conversion is videoconvert's
                pnm.write_pnm(loc, frame[..., 1])
            else:
                r, g, b, _ = VideoFormat.rgb_offsets(spec.format)
                pnm.write_pnm(loc, frame[..., [r, g, b]])
        else:
            pnm.write_pnm(loc, frame)
