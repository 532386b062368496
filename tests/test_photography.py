"""GstPhotography interface surface on Camera
(gst-libs/gst/interfaces/photography.h) — property round-trips with the
capability-probe semantics, plus a visible compute effect per wired
property (the adjust stage acts on frames, not dead config)."""

import numpy as np
import pytest

from gstbad.session.camera import (
    CAPS_EV_COMP, CAPS_FLASH, CAPS_ISO_SPEED, CAPS_SCENE, CAPS_TONE,
    CAPS_WB_MODE, CAPS_ZOOM, Camera, FOCUS_STATUS_SUCCESS, MODE_IMAGE)


def make_cam(**kw):
    return Camera(source="videotestsrc pattern=bars width=64 height=48 "
                  "format=AYUV", window=2, **kw)


def grab(cam):
    frames = []
    cam.set_viewfinder(lambda b, spec: frames.append(
        np.asarray(b.data)[np.asarray(b.valid)]))
    cam.run_viewfinder(1)
    cam.set_viewfinder(None)
    return np.concatenate(frames)[0]       # one AYUV frame [H, W, 4]


# -- capability probe ---------------------------------------------------------

def test_capabilities_probe():
    cam = make_cam()
    caps = cam.get_capabilities()
    for bit in (CAPS_EV_COMP, CAPS_ISO_SPEED, CAPS_WB_MODE, CAPS_TONE,
                CAPS_SCENE, CAPS_FLASH, CAPS_ZOOM):
        assert caps & bit, bit


# -- property round-trips (gst_photography_set_*/get_* return semantics) -----

def test_property_roundtrips():
    cam = make_cam()
    assert cam.set_ev_compensation(1.5) and cam.get_ev_compensation() == 1.5
    assert not cam.set_ev_compensation(9.0)         # out of range -> FALSE
    assert cam.set_iso_speed(400) and cam.get_iso_speed() == 400
    assert not cam.set_iso_speed(-1)
    assert cam.set_white_balance_mode("tungsten")
    assert cam.get_white_balance_mode() == "tungsten"
    assert not cam.set_white_balance_mode("plasma")
    assert cam.set_color_tone_mode("sepia")
    assert cam.get_color_tone_mode() == "sepia"
    assert not cam.set_color_tone_mode("vaporwave")
    assert cam.set_flash_mode("red-eye") and cam.get_flash_mode() == "red-eye"
    assert not cam.set_flash_mode("strobe")
    assert cam.set_focus_mode("macro") and cam.get_focus_mode() == "macro"
    assert not cam.set_focus_mode("laser")
    assert cam.set_noise_reduction(0b101)
    assert cam.get_noise_reduction() == 0b101
    assert not cam.set_noise_reduction(1 << 9)
    assert cam.set_flicker_mode("50hz") and cam.get_flicker_mode() == "50hz"
    assert cam.set_exposure_mode("manual")
    assert cam.set_exposure_time(20000) and cam.get_exposure_time() == 20000
    assert cam.set_aperture(28) and cam.get_aperture() == 28
    # lens-focus requires manual focus mode (photography.h:411)
    assert not cam.set_lens_focus(0.4)
    cam.set_focus_mode("manual")
    assert cam.set_lens_focus(0.4) and cam.get_lens_focus() == 0.4


# -- visible effects ----------------------------------------------------------

def test_ev_compensation_effect():
    cam = make_cam()
    base = grab(cam)
    cam.set_ev_compensation(1.0)            # +1 EV = 2x luma gain
    bright = grab(cam)
    y0 = base[..., 1].astype(np.int64)
    y1 = bright[..., 1].astype(np.int64)
    np.testing.assert_array_equal(y1, np.clip(y0 * 2, 0, 255))


def test_iso_speed_effect():
    cam = make_cam()
    base = grab(cam)
    cam.set_iso_speed(200)                  # 2x analog gain
    hot = grab(cam)
    np.testing.assert_array_equal(
        hot[..., 1], np.clip(base[..., 1].astype(np.int64) * 2, 0, 255))
    cam.set_iso_speed(0)                    # auto = unity
    np.testing.assert_array_equal(grab(cam)[..., 1], base[..., 1])


def test_white_balance_effect():
    cam = make_cam()
    base = grab(cam)
    cam.set_white_balance_mode("tungsten")  # damp V, boost U
    cool = grab(cam)
    u0 = base[..., 2].astype(np.float64) - 128
    v0 = base[..., 3].astype(np.float64) - 128
    np.testing.assert_array_equal(
        cool[..., 2], np.clip(np.round(u0 * 1.25 + 128), 0, 255))
    np.testing.assert_array_equal(
        cool[..., 3], np.clip(np.round(v0 * 0.8 + 128), 0, 255))
    np.testing.assert_array_equal(base[..., 1], cool[..., 1])  # luma same


def test_color_tone_effects():
    cam = make_cam()
    base = grab(cam)
    cam.set_color_tone_mode("grayscale")
    g = grab(cam)
    assert (g[..., 2] == 128).all() and (g[..., 3] == 128).all()
    np.testing.assert_array_equal(g[..., 1], base[..., 1])
    cam.set_color_tone_mode("negative")
    n = grab(cam)
    np.testing.assert_array_equal(n[..., 1], 255 - base[..., 1])
    cam.set_color_tone_mode("sepia")
    s = grab(cam)
    assert (s[..., 2] == 114).all() and (s[..., 3] == 144).all()
    cam.set_color_tone_mode("solarize")
    sol = grab(cam)
    y0 = base[..., 1]
    expect = np.where(y0 < 128, y0, 255 - y0.astype(np.int64))
    np.testing.assert_array_equal(sol[..., 1], expect)
    cam.set_color_tone_mode("normal")
    np.testing.assert_array_equal(grab(cam), base)


def test_scene_mode_presets():
    cam = make_cam()
    assert cam.set_scene_mode("night")      # presets ev+1, iso 800
    assert cam.get_scene_mode() == "night"
    assert cam.get_ev_compensation() == 1.0
    assert cam.get_iso_speed() == 800
    assert not cam.set_scene_mode("underwater")
    cam2 = make_cam()
    cam2.set_scene_mode("candlelight")
    assert cam2.get_white_balance_mode() == "tungsten"
    cam3 = make_cam()
    cam3.set_scene_mode("barcode")
    assert cam3.get_color_tone_mode() == "grayscale"
    g = grab(cam3)
    assert (g[..., 2] == 128).all()


def test_color_temperature_manual_wb():
    cam = make_cam()
    base = grab(cam)
    assert cam.set_color_temperature(3000)  # warm light -> cool correction
    assert cam.get_color_temperature() == 3000
    assert cam.get_white_balance_mode() == "manual"
    cool = grab(cam)
    # U (B-Y) boosted, V (R-Y) damped
    u_dev0 = np.abs(base[..., 2].astype(int) - 128).mean()
    u_dev1 = np.abs(cool[..., 2].astype(int) - 128).mean()
    v_dev0 = np.abs(base[..., 3].astype(int) - 128).mean()
    v_dev1 = np.abs(cool[..., 3].astype(int) - 128).mean()
    assert u_dev1 > u_dev0 and v_dev1 < v_dev0
    assert not cam.set_color_temperature(100)


def test_autofocus_message():
    cam = make_cam()
    cam.set_autofocus(True)
    done = cam.bus.pop(name="autofocus-done")
    assert len(done) == 1
    assert done[0]["focus-status"] == FOCUS_STATUS_SUCCESS


def test_effects_reach_captures(tmp_path):
    """The adjust stage sits in the source path, so captures see it."""
    import os
    os.chdir(tmp_path)
    from gstbad.io import pnm
    cam = Camera(source="videotestsrc pattern=gradient width=32 height=24 "
                 "format=AYUV", mode=MODE_IMAGE, window=2)
    loc0 = cam.start_capture()
    _, img0 = pnm.read_pnm(loc0)
    cam.set_color_tone_mode("negative")
    loc1 = cam.start_capture()
    _, img1 = pnm.read_pnm(loc1)
    np.testing.assert_array_equal(img1, 255 - img0)
