#!/usr/bin/env python3
"""Benchmark driver — streams one JSON line per result; headline line last.

Headline metric (BASELINE.md): 1080p frames/sec/chip for the fused
10-element filter graph; vs_baseline = speedup over the compiled single-core
C reference (native/refbench — reference ORC backup kernels + C
transcriptions, see BASELINE_C.json).  Falls back to the numpy golden if the
C harness is unavailable (labeled in the "baseline" field).

Every line names the device it ran on (JAX platform, device kind and
count) and the card's name and power limit.  A run that finds no GPU fails.
The FINAL stdout line is always the headline record (re-printed after a
sweep).

Usage: python bench.py [--config ten_element] [--all] [--window N]
"""

import argparse
import json
import os
import sys
import time


_CONTEXT = {}


def emit(rec):
    print(json.dumps({**rec, **_CONTEXT}), flush=True)


# Per-config window caps (frames per compiled step): 4K frames are 33 MB
# and the warps and blur hold wide intermediates, so their windows stay
# small; every other config runs at --window.
WINDOW_CAPS = {"config4_warp": 16, "warp_4k": 16, "warp_1080p": 32,
               "config2_blur": 128}


def time_pipeline(pipeline, window: int, n_windows: int, warmup: int = 2,
                  reps: int = 1):
    """Time the fused step function steady-state (data stays on device).

    reps > 1 measures the run `reps` times and returns
    (median_fps, [fps...]): a median-of-N is the anchor for comparing
    runs."""
    import statistics

    import jax

    pipeline.negotiate()
    step = pipeline.compile(window)
    params = pipeline.params()
    states = pipeline.init_states(window)
    # warmup (compile + cache)
    for _ in range(warmup):
        states, batch, _ = step(params, states, None)
    jax.block_until_ready(batch)
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n_windows):
            states, batch, _ = step(params, states, None)
        jax.block_until_ready(batch)
        dt = time.perf_counter() - t0
        runs.append((n_windows * window) / dt)
    if reps == 1:
        return runs[0]
    return statistics.median(runs), runs


def config5_fidelity(width=1280, height=720, n_frames=30, window=10):
    """BASELINE config 5's quality gate as a measured artifact: the
    telecine round trip (interlace 2:3 -> fieldanalysis -> ivtc) scored
    by the iqa/compare SSIM oracle against the progressive source
    (ext/iqa/iqa.c:195-290, gst/debugutils/gstcompare.c:355-428).

    ivtc's first emitted frame predates its field queue warm-up and is
    skipped; each remaining output frame is scored against its
    best-aligned source frame (the inverse-telecine cadence duplicates
    frames, so alignment is by content, monotone in the source)."""
    import numpy as np

    from gstbad.core.pipeline import parse_launch
    from gstbad.models import benchmarks
    from gstbad.ops.ssim import ssim_plane

    src = parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 framerate=24/1 ! fakesink")
    orig = np.concatenate([np.asarray(b.data)
                           for b in src.run(n_frames=n_frames,
                                            window=window)])
    chain = benchmarks.config5_ivtc(width, height)
    out = np.concatenate([np.asarray(b.data)
                          for b in chain.run(n_frames=n_frames,
                                             window=window)])
    scores = []
    j0 = 0
    for i in range(1, out.shape[0]):      # skip the warm-up frame
        # monotone best-match within the cadence lookahead
        cand = range(j0, min(j0 + 4, orig.shape[0]))
        if not len(cand):
            break
        errs = [np.abs(out[i].astype(np.int64)
                       - orig[j].astype(np.int64)).mean() for j in cand]
        j = j0 + int(np.argmin(errs))
        j0 = j
        scores.append(float(ssim_plane(out[i], orig[j])))
    ssim = float(np.mean(scores)) if scores else 0.0
    return {"ssim": round(ssim, 6),
            "dssim": round((1.0 - ssim) / 2.0, 6),   # compare.c dssim
            "frames_scored": len(scores)}


def numpy_baseline_fps(width=1920, height=1080, reps=2):
    """Single-core numpy golden for the 10-element graph, frames/sec.

    Fallback denominator only — the honest baseline is the compiled C
    harness (c_baseline_fps)."""
    import numpy as np
    from gstbad.models.benchmarks import ten_element_golden

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (height, width, 4), dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(reps):
        ten_element_golden(img, 0)
    dt = time.perf_counter() - t0
    return reps / dt


def c_baseline_fps():
    """Compiled-C single-core fps for the 10-element graph, or None.

    Prefers the recorded BASELINE_C.json (written by tools/ref_baseline.py);
    if absent, tries a live build+measure (a few seconds of cc -O3)."""
    here = os.path.dirname(os.path.abspath(__file__))
    rec = os.path.join(here, "BASELINE_C.json")
    try:
        if os.path.exists(rec):
            with open(rec) as f:
                data = json.load(f)
            fps = data.get("graph10_1080p_fps")
            if fps:
                return float(fps)
    except Exception:  # noqa: BLE001
        pass
    try:
        sys.path.insert(0, os.path.join(here, "tools"))
        import ref_baseline
        return float(ref_baseline.measure_graph10_fps())
    except Exception as e:  # noqa: BLE001
        print(f"bench: C baseline unavailable ({e}); "
              "falling back to numpy golden", file=sys.stderr)
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ten_element")
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--all", action="store_true",
                    help="also sweep every BENCHMARKS config")
    ap.add_argument("--profile", action="store_true",
                    help="per-element marginal cost attribution on the "
                         "headline graph (PipelineTracer.profile_elements; "
                         "compiles one prefix program per element)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions; the reported value is the "
                         "median")
    args = ap.parse_args()

    import jax

    from gstbad.models import build, BENCHMARKS
    from gstbad.utils.compile_cache import enable_compile_cache
    from gstbad.utils.device import card_info, device_info

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: no GPU (JAX backend {jax.default_backend()!r}); "
                 "device numbers come only from a GPU run")
    enable_compile_cache()
    _CONTEXT.update(device=device_info(), card=card_info())

    c_fps = c_baseline_fps()
    if c_fps is not None:
        baseline, baseline_kind = c_fps, "compiled_C_single_core"
    else:
        baseline, baseline_kind = numpy_baseline_fps(), "numpy_golden_single_core"
    print(f"bench: baseline {baseline:.2f} fps ({baseline_kind})",
          file=sys.stderr)

    pipeline = build(args.config)
    res = time_pipeline(pipeline, args.window, args.windows,
                        reps=max(1, args.reps))
    fps, fps_runs = res if isinstance(res, tuple) else (res, [res])

    # Byte floor for the headline graph: each frame is H*W*4 u8 and the
    # fused program must at least read the source and write the sink once
    # (two traversals of the window).
    frame_bytes = 1920 * 1080 * 4
    achieved_gbps = fps * frame_bytes * 2 / 1e9
    if args.config == "ten_element":
        headline = {
            "metric": "1080p_frames_per_sec_per_chip_10elem_graph",
            "value": round(fps, 2),
            "unit": "frames/s",
            "vs_baseline": round(fps / baseline, 2),
            "baseline": baseline_kind,
            "baseline_fps": round(baseline, 2),
            "min_bytes_per_frame": frame_bytes * 2,
            "achieved_min_gbps": round(achieved_gbps, 2),
        }
    else:
        headline = {
            "metric": f"fps_{args.config}",
            "value": round(fps, 2),
            "unit": "frames/s",
            "vs_baseline": None,
            "window": args.window,
        }
    if len(fps_runs) > 1:
        headline["runs"] = [round(f, 2) for f in fps_runs]
        headline["n_runs"] = len(fps_runs)
    if args.config == "config5_ivtc":
        # BASELINE config 5 is defined with its iqa SSIM/DSSIM score
        fid = config5_fidelity()
        headline.update(fid)
        emit({"metric": "config5_telecine_ssim", **fid})
    if args.profile:
        # per-element marginal attribution, emitted BEFORE the headline so
        # the last line stays the headline
        from gstbad.utils.trace import PipelineTracer
        prof_pipeline = build(args.config)
        prof = PipelineTracer(prof_pipeline).profile_elements(
            window=args.window, reps=3)
        emit({"metric": "per_element_marginal_ms_per_window",
              "window": args.window, "profile": prof})

    emit(headline)

    if args.all:
        for name in BENCHMARKS:
            if name == args.config:
                continue
            p = build(name)
            w = min(args.window, WINDOW_CAPS.get(name, args.window))
            f = time_pipeline(p, w, args.windows)
            rec = {"metric": f"fps_{name}", "value": round(f, 2),
                   "unit": "frames/s", "vs_baseline": None, "window": w}
            if name == "config5_ivtc":
                rec.update(config5_fidelity())
            emit(rec)
        # the last stdout line is the headline
        emit(headline)


if __name__ == "__main__":
    main()
