#!/usr/bin/env python3
"""Build + run the compiled-C reference baseline (native/refbench).

Produces BASELINE_C.json at the repo root with single-core fps for the
10-element headline graph and per-kernel rates, and cross-checks golden/
against the compiled code — including REAL reference code (the ORC backup
kernels compiled from /root/reference/gst/.../gst*orc-dist.c, -DDISABLE_ORC),
which retires the "golden was never validated against compiled C" risk
(VERDICT.md Weak #9) for burn, bayer and the fieldanalysis metrics.

Usage: python tools/ref_baseline.py [--out BASELINE_C.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
SRC = os.path.join(REPO, "native", "refbench", "refbench.c")
SHIM = os.path.join(REPO, "native", "refbench")
DIST_UNITS = [
    f"{REF}/gst/gaudieffects/gstgaudieffectsorc-dist.c",
    f"{REF}/gst/videofilters/gstscenechangeorc-dist.c",
    f"{REF}/gst/fieldanalysis/gstfieldanalysisorc-dist.c",
    f"{REF}/gst/bayer/gstbayerorc-dist.c",
]

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def build(force: bool = False) -> str:
    """Compile librefbench.so into a cache dir; returns the .so path."""
    cache = os.path.join(REPO, "native", "refbench", "build")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "librefbench.so")
    srcs = [SRC] + [p for p in DIST_UNITS if os.path.exists(p)]
    if (not force and os.path.exists(so)
            and all(os.path.getmtime(so) > os.path.getmtime(s) for s in srcs)):
        return so
    cmd = ["cc", "-O3", "-march=native", "-fno-math-errno", "-shared",
           "-fPIC", "-DDISABLE_ORC", f"-I{SHIM}", *srcs, "-lm", "-o", so]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return so


def load():
    lib = ctypes.CDLL(build())
    lib.rb_graph10_seconds.restype = ctypes.c_double
    lib.rb_graph10_seconds.argtypes = [
        _u8p, _u8p, _u8p, _u8p, ctypes.c_int, ctypes.c_int, _u8p,
        ctypes.c_int]
    lib.gaudi_orc_burn.argtypes = [_u32p, _u32p, ctypes.c_int, ctypes.c_int]
    lib.fieldanalysis_orc_same_parity_sad_planar_yuv.argtypes = [
        _u32p, _u8p, _u8p, ctypes.c_int, ctypes.c_int]
    lib.rb_gaussianblur.argtypes = [
        _u8p, _u8p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    ci = ctypes.c_int
    lib.rb_coloreffects_luma.argtypes = [_u8p, _u8p, ci, _u8p]
    lib.rb_solarize.argtypes = [_u8p, _u8p, ci, ci, ci, ci]
    lib.rb_chromium.argtypes = [_u8p, _u8p, ci, ci, ci]
    lib.rb_dodge.argtypes = [_u8p, _u8p, ci]
    lib.rb_exclusion.argtypes = [_u8p, _u8p, ci, ci]
    lib.rb_dilate.argtypes = [_u8p, _u8p, ci, ci, ci]
    lib.rb_chromahold.argtypes = [_u8p, _u8p, ci, ci, ci, ci, ci]
    lib.rb_rgb_to_y.argtypes = [_u8p, _u8p, ci]
    lib.rb_zebrastripe.argtypes = [_u8p, ci, ci, ci, ci]
    _f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rb_mixmatrix_f32.argtypes = [_f32p, _f32p, ci, _f32p, ci, ci]
    lib.rb_freeverb_seconds.restype = ctypes.c_double
    lib.rb_freeverb_seconds.argtypes = [_f32p, _f32p, ci, ci, ci]
    lib.rb_remap_clamp.argtypes = [_u8p, _u8p, _f64p, ci, ci]
    lib.rb_bayer2rgb_bgra.argtypes = [_u8p, _u8p, _u8p, ci, ci]
    lib.rb_ivtc_comb_score.restype = ci
    lib.rb_ivtc_comb_score.argtypes = [_u8p, _u8p, ci, ci]
    return lib


def sepia_table() -> np.ndarray:
    from gstbad.elements.video._coloreffects_tables import TABLES
    return np.ascontiguousarray(TABLES["sepia"].astype(np.uint8))


def crosscheck(lib) -> dict:
    """golden/ vs compiled C.  burn + fieldanalysis SAD run REAL reference
    code (ORC backup C); the rest checks this harness's transcriptions."""
    from gstbad.golden import gaudieffects as g
    from gstbad.golden import fieldanalysis as g_fa
    from gstbad.golden import videofilters as g_vf
    from gstbad.golden import coloreffects as g_ce

    rng = np.random.default_rng(42)
    h, w = 64, 128
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    results = {}

    # 1. burn: reference ORC backup vs golden (REAL reference code)
    out = np.empty(h * w, np.uint32)
    lib.gaudi_orc_burn(out, np.ascontiguousarray(img).view(np.uint32).ravel(),
                       175, h * w)
    got = out.view(np.uint8).reshape(h, w, 4)
    results["burn_ref_orc_vs_golden"] = bool((got == g.burn(img)).all())

    # 2. fieldanalysis SAD: reference ORC backup vs golden numerator
    f0 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    f1 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    acc = np.zeros(1, np.uint32)
    a = np.ascontiguousarray(f0[0::2]).ravel()
    b = np.ascontiguousarray(f1[0::2]).ravel()
    lib.fieldanalysis_orc_same_parity_sad_planar_yuv(acc, a, b, 16, a.size)
    want = g_fa.same_parity_sad(f0, 0, f1, 0) * (0.5 * w * h)
    results["fieldanalysis_sad_ref_orc_vs_golden"] = (
        int(acc[0]) == int(round(want)))

    # 3. the full 10-element chain, stage-for-stage vs golden
    n = h * w
    tbl = sepia_table()
    x_g = g_ce.coloreffects_rgb(img, "sepia", (2, 1, 0))
    x_g = g.solarize(x_g)
    x_g = g.chromium(x_g)
    x_g = g.dodge(x_g)
    x_g = g.burn(x_g)
    x_g = g.exclusion(x_g)
    x_g = g.dilate(x_g)
    x_g = g_ce.chromahold(x_g)
    y_g = ((66 * x_g[..., 2].astype(np.int64)
            + 129 * x_g[..., 1].astype(np.int64)
            + 25 * x_g[..., 0].astype(np.int64) + 4096) >> 8).clip(0, 255)
    y_g = g_vf.zebrastripe_y(y_g.astype(np.uint8), 90, 0)

    buf_a = np.empty(n * 4, np.uint8)
    buf_b = np.empty(n * 4, np.uint8)
    ybuf = np.empty(n, np.uint8)
    src = np.ascontiguousarray(img).ravel()
    lib.rb_graph10_seconds(src, buf_a, buf_b, ybuf, h, w, tbl.ravel(), 1)
    results["graph10_c_vs_golden"] = bool(
        (ybuf.reshape(h, w) == y_g).all())

    # 4. gaussianblur transcription vs golden (float; allow 1 LSB)
    dst = np.empty(n * 4, np.uint8)
    tmp = np.empty(n * 4, np.float32)
    lib.rb_gaussianblur(dst, src, tmp, h, w, np.float32(1.2))
    diff = np.abs(dst.reshape(h, w, 4).astype(np.int16)
                  - g.gaussianblur(img, 1.2).astype(np.int16)).max()
    results["gaussianblur_c_vs_golden_maxdiff"] = int(diff)
    results["gaussianblur_ok"] = bool(diff <= 1)

    # 5. freeverb C vs golden serial float32 (-O3 FMA contraction only)
    from gstbad.golden import audio as g_audio
    x = ((rng.random((4096, 2)) - 0.5) * 0.8).astype(np.float32)
    y = np.empty_like(x)
    lib.rb_freeverb_seconds(np.ascontiguousarray(x.ravel()), y.ravel(),
                            4096, 44100, 1)
    # the ctypes out buffer was written in place; re-read through y
    want = g_audio.Freeverb(44100).process_stereo_float(x)
    results["freeverb_c_vs_golden_maxdiff"] = float(
        np.abs(y - want).max())
    results["freeverb_ok"] = bool(np.abs(y - want).max() <= 1e-5)

    # 6. bayer2rgb: REAL reference ORC merge kernels vs golden
    from gstbad.golden import bayer as g_bayer
    raw = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    bdst = np.empty(64 * 128 * 4, np.uint8)
    btmp = np.empty(8 * 128, np.uint8)
    lib.rb_bayer2rgb_bgra(bdst, np.ascontiguousarray(raw).ravel(), btmp,
                          64, 128)
    want_b = g_bayer.bayer2rgb(raw, "bggr", out_order="BGRA")
    results["bayer2rgb_ref_orc_vs_golden"] = bool(
        (bdst.reshape(64, 128, 4) == want_b).all())

    # 7. remap transcription vs golden fisheye (trunc-index copy)
    from gstbad.golden import geometric as g_geo
    mp = g_geo.fisheye_map(w, h)
    rdst = np.zeros(n * 4, np.uint8)
    lib.rb_remap_clamp(rdst, src, np.ascontiguousarray(
        mp.reshape(-1, 2).astype(np.float64)).ravel(), h, w)
    want_r = g_geo.remap(img, mp, off_edge="clamp")
    results["remap_c_vs_golden"] = bool(
        (rdst.reshape(h, w, 4) == want_r).all())

    # 8. ivtc comb score vs golden
    from gstbad.golden import ivtc as g_ivtc
    t0f = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    b0f = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    got_s = lib.rb_ivtc_comb_score(np.ascontiguousarray(t0f).ravel(),
                                   np.ascontiguousarray(b0f).ravel(),
                                   64, 128)
    results["ivtc_comb_c_vs_golden"] = (
        int(got_s) == int(g_ivtc.get_comb_score(t0f, b0f)))
    return results


def measure_graph10_fps(width=1920, height=1080, min_seconds=2.0) -> float:
    lib = load()
    rng = np.random.default_rng(0)
    n = width * height
    frame = rng.integers(0, 256, n * 4, dtype=np.uint8)
    buf_a = np.empty(n * 4, np.uint8)
    buf_b = np.empty(n * 4, np.uint8)
    ybuf = np.empty(n, np.uint8)
    tbl = sepia_table().ravel()
    reps, total = 1, 0.0
    while True:
        total = lib.rb_graph10_seconds(frame, buf_a, buf_b, ybuf,
                                       height, width, tbl, reps)
        if total >= min_seconds:
            break
        reps = max(reps * 2, int(reps * min_seconds / max(total, 1e-3)) + 1)
    return reps / total


def measure_kernels(lib, width=1920, height=1080) -> dict:
    """Per-kernel single-core fps at 1080p (informational)."""
    rng = np.random.default_rng(0)
    n = width * height
    src = rng.integers(0, 256, n * 4, dtype=np.uint8)
    dst = np.empty(n * 4, np.uint8)
    tbl = sepia_table().ravel()
    out = {}

    def rate(name, fn, reps=20):
        fn()  # warmup
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = round(reps / (time.perf_counter() - t0), 2)

    rate("sepia", lambda: lib.rb_coloreffects_luma(dst, src, n, tbl))
    rate("solarize", lambda: lib.rb_solarize(dst, src, n, 127, 50, 185))
    rate("chromium", lambda: lib.rb_chromium(dst, src, n, 200, 1))
    rate("dodge", lambda: lib.rb_dodge(dst, src, n))
    burn_d = np.empty(n, np.uint32)
    burn_s = src.view(np.uint32)
    rate("burn_ref_orc", lambda: lib.gaudi_orc_burn(burn_d, burn_s, 175, n))
    rate("exclusion", lambda: lib.rb_exclusion(dst, src, n, 175))
    rate("dilate", lambda: lib.rb_dilate(dst, src, height, width, 0), reps=5)
    rate("chromahold",
         lambda: lib.rb_chromahold(dst, src, n, 255, 0, 0, 30), reps=5)
    ybuf = np.empty(n, np.uint8)
    rate("rgb_to_y", lambda: lib.rb_rgb_to_y(ybuf, src, n))
    rate("zebrastripe", lambda: lib.rb_zebrastripe(ybuf, height, width, 90, 0))
    tmp = np.empty(n * 4, np.float32)
    rate("gaussianblur_sigma1.2",
         lambda: lib.rb_gaussianblur(dst, src, tmp, height, width,
                                     np.float32(1.2)), reps=3)
    return out


def measure_config3_audio(lib, rate=48000, block=4800, min_seconds=2.0):
    """Config 3: audiomixmatrix 8->2 + freeverb at 48 kHz -> realtime
    factor (x realtime, single core)."""
    rng = np.random.default_rng(0)
    x8 = ((rng.random((block, 8)) - 0.5) * 0.8).astype(np.float32)
    matrix = np.full((2, 8), 0.125, np.float32)
    matrix[0, 0] = matrix[1, 1] = 1.0
    mixed = np.empty((block, 2), np.float32)
    out = np.empty((block, 2), np.float32)

    t0 = time.perf_counter()
    mix_reps = 50
    for _ in range(mix_reps):
        lib.rb_mixmatrix_f32(mixed.ravel(), x8.ravel(), block,
                             matrix.ravel(), 8, 2)
    mix_secs_per_block = (time.perf_counter() - t0) / mix_reps

    reps = 8
    while True:
        secs = lib.rb_freeverb_seconds(mixed.ravel(), out.ravel(), block,
                                       rate, reps)
        if secs >= min_seconds:
            break
        reps = max(reps * 2, int(reps * min_seconds / max(secs, 1e-3)) + 1)
    fv_secs_per_block = secs / reps
    chain_secs = mix_secs_per_block + fv_secs_per_block
    return {
        "audio_chain_realtime_x": round((block / rate) / chain_secs, 2),
        "freeverb_realtime_x": round((block / rate) / fv_secs_per_block, 2),
    }


def measure_config4_warp(lib, width=3840, height=2160):
    """Config 4: bayer2rgb + fisheye + twirl at 4K (the per-frame remap
    loops over the precalc maps + the reference ORC demosaic)."""
    from gstbad.golden import geometric as g_geo
    rng = np.random.default_rng(0)
    n = width * height
    raw = rng.integers(0, 256, n, dtype=np.uint8)
    rgba = np.empty(n * 4, np.uint8)
    tmp8 = np.empty(8 * width, np.uint8)
    buf = np.empty(n * 4, np.uint8)
    out = np.zeros(n * 4, np.uint8)
    fish = np.ascontiguousarray(
        g_geo.fisheye_map(width, height).reshape(-1, 2)
        .astype(np.float64)).ravel()
    twirl = np.ascontiguousarray(
        g_geo.twirl_map(width, height).reshape(-1, 2)
        .astype(np.float64)).ravel()

    def frame():
        lib.rb_bayer2rgb_bgra(rgba, raw, tmp8, height, width)
        lib.rb_remap_clamp(buf, rgba, fish, height, width)
        lib.rb_remap_clamp(out, buf, twirl, height, width)

    frame()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        frame()
    secs = (time.perf_counter() - t0) / reps
    return {"config4_4k_fps": round(1.0 / secs, 2)}


def measure_config5_ivtc(lib, width=1280, height=720):
    """Config 5: the ivtc cadence cost model per OUTPUT frame — the
    reference computes similarity() (one comb score) for up to 3 field
    pairings plus one woven reconstruct copy (gstivtc.c:455-540)."""
    rng = np.random.default_rng(0)
    top = rng.integers(0, 256, (height, width), dtype=np.uint8)
    bottom = rng.integers(0, 256, (height, width), dtype=np.uint8)
    tf = np.ascontiguousarray(top).ravel()
    bf = np.ascontiguousarray(bottom).ravel()

    def frame():
        for _ in range(3):
            lib.rb_ivtc_comb_score(tf, bf, height, width)
        il = np.empty((height, width), np.uint8)  # reconstruct weave copy
        il[0::2] = top[0::2]
        il[1::2] = bottom[1::2]

    frame()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        frame()
    secs = (time.perf_counter() - t0) / reps
    return {"config5_720p_fps": round(1.0 / secs, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "BASELINE_C.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    lib = load()
    checks = crosscheck(lib)
    fps = measure_graph10_fps()
    kernels = measure_kernels(lib)
    configs = {}
    configs.update(measure_config3_audio(lib))
    configs.update(measure_config4_warp(lib))
    configs.update(measure_config5_ivtc(lib))
    rec = {
        "graph10_1080p_fps": round(fps, 2),
        "kernel_fps_1080p": kernels,
        "configs": configs,
        "crosscheck": checks,
        "cpu": platform.processor() or platform.machine(),
        "ncpu_present_but_single_threaded": os.cpu_count(),
        "compiler": "cc -O3 -march=native",
        "note": ("single-core compiled C: reference ORC backup kernels from "
                 "/root/reference (burn, fieldanalysis) + cited C "
                 "transcriptions (native/refbench/refbench.c)"),
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    if not all(v for k, v in checks.items() if k.endswith(("_vs_golden", "_ok"))):
        print("CROSSCHECK FAILED", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
