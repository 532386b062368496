"""The benchmark pipeline graphs from BASELINE.md / BASELINE.json.

Each entry builds a Pipeline (launch-string form, so the element API is
exercised exactly the way users drive it) plus the matching golden CPU
function used as the single-core reference denominator.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.golden import coloreffects as g_ce
from gstbad.golden import gaudieffects as g_gaudi
from gstbad.golden import geometric as g_geo
from gstbad.golden import bayer as g_bayer
from gstbad.golden import audio as g_audio
from gstbad.golden import videofilters as g_vf


def config1_sepia(width=1920, height=1080) -> Pipeline:
    """coloreffects preset=sepia on 1080p30 (BASELINE config 1)."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! coloreffects preset=sepia ! fakesink")


def config1_golden(frames: np.ndarray) -> np.ndarray:
    out = np.empty_like(frames)
    for i in range(frames.shape[0]):
        out[i] = g_ce.coloreffects_rgb(frames[i], "sepia", (2, 1, 0))
    return out


def config2_gaudi(width=1920, height=1080) -> Pipeline:
    """gaussianblur -> solarize -> chromium fused (BASELINE config 2).

    The reference runs these as three elements on three threads in AYUV/BGRx;
    the gaudieffects word filters take BGRx, gaussianblur AYUV — the
    reference pipeline would insert videoconvert.  This graph runs
    solarize -> chromium -> dodge -> burn -> exclusion as one fused program
    (the point-op family), plus gaussianblur separately on AYUV below.
    """
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! solarize ! chromium ! dodge ! burn ! exclusion "
        "! fakesink")


def config2_golden(frames: np.ndarray) -> np.ndarray:
    out = np.empty_like(frames)
    for i in range(frames.shape[0]):
        x = g_gaudi.solarize(frames[i])
        x = g_gaudi.chromium(x)
        x = g_gaudi.dodge(x)
        x = g_gaudi.burn(x)
        out[i] = g_gaudi.exclusion(x)
    return out


def config2_blur(width=1920, height=1080) -> Pipeline:
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=AYUV ! gaussianblur sigma=1.2 ! fakesink")


def config3_audio() -> Pipeline:
    """audiomixmatrix -> freeverb -> removesilence, 48 kHz 8-channel in
    (BASELINE config 3 — the full three-element chain incl. the VAD scan)."""
    matrix = "<" + ",".join(
        "<" + ",".join("1.0" if i == o else "0.125" for i in range(8)) + ">"
        for o in range(2)) + ">"
    return parse_launch(
        "audiotestsrc wave=sine channels=8 format=F32 samplesperbuffer=4800 "
        f"! audiomixmatrix matrix='{matrix}' ! freeverb "
        "! audioconvert format=S16 channels=1 ! removesilence ! fakesink")


def config4_warp(width=3840, height=2160) -> Pipeline:
    """bayer2rgb + fisheye warp at 4K (BASELINE config 4)."""
    return parse_launch(
        f"videotestsrc pattern=gradient width={width} height={height} "
        "format=ARGB ! rgb2bayer ! bayer2rgb format=ARGB "
        "! fisheye ! twirl ! fakesink")


def warp_1080p(width=1920, height=1080) -> Pipeline:
    """Single fisheye warp, 1080p."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! fisheye ! fakesink")


def warp_4k(width=3840, height=2160) -> Pipeline:
    """Single fisheye warp at 4K."""
    return warp_1080p(width, height)


def config5_ivtc(width=1280, height=720) -> Pipeline:
    """interlace (2:3 telecine) -> fieldanalysis -> ivtc round trip
    (BASELINE config 5: the ivtc/fieldanalysis + interlace graph; the
    iqa SSIM/DSSIM score is recorded by bench.py config5_fidelity)."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 framerate=24/1 ! interlace pattern=2:3 "
        "! fieldanalysis ! ivtc ! fakesink")


def combdetect_720p(width=1280, height=720) -> Pipeline:
    """interlace -> combdetect zebra paint (BASELINE combdetect row)."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 framerate=24/1 ! interlace pattern=2:3 "
        "! combdetect ! fakesink")


def ten_element_golden(frame: np.ndarray, t: int) -> np.ndarray:
    """Luma plane of the ten-element graph for one BGRx frame: the numpy
    golden chain, then BT.601 luma and the zebra stripe at phase t (the
    frame's index in the stream)."""
    x = g_ce.coloreffects_rgb(frame, "sepia", (2, 1, 0))
    x = g_gaudi.solarize(x)
    x = g_gaudi.chromium(x)
    x = g_gaudi.dodge(x)
    x = g_gaudi.burn(x)
    x = g_gaudi.exclusion(x)
    x = g_gaudi.dilate(x)
    x = g_ce.chromahold(x)
    r, g, b = (x[..., c].astype(np.int64) for c in (2, 1, 0))
    y = ((66 * r + 129 * g + 25 * b + 4096) >> 8).clip(0, 255)
    return g_vf.zebrastripe_y(y.astype(np.uint8), 90, t)


def ten_element_graph(width=1920, height=1080) -> Pipeline:
    """The north-star 10-element 1080p filter graph (BASELINE.md)."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! coloreffects preset=sepia ! solarize ! chromium "
        "! dodge ! burn ! exclusion ! dilate ! chromahold "
        "! videoconvert format=AYUV ! zebrastripe ! fakesink")


BENCHMARKS: Dict[str, Callable[[], Pipeline]] = {
    "config1_sepia": config1_sepia,
    "config2_gaudi": config2_gaudi,
    "config2_blur": config2_blur,
    "config3_audio": config3_audio,
    "config4_warp": config4_warp,
    "warp_1080p": warp_1080p,
    "warp_4k": warp_4k,
    "config5_ivtc": config5_ivtc,
    "combdetect_720p": combdetect_720p,
    "ten_element": ten_element_graph,
}


def build(name: str, **kw) -> Pipeline:
    return BENCHMARKS[name](**kw)
