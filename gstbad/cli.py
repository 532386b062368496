"""Console entry points — gstbad-launch (the gst-launch-1.0 analog) and
gstbad-transcode (the gst-transcoder CLI analog, tools/gst-transcoder.c)."""

import argparse
import sys
import time


def launch_main(argv=None):
    """gst-launch-1.0 analog: build a pipeline from a launch string,
    run it, print negotiated specs (-v), bus messages (-m) and a
    throughput summary."""
    ap = argparse.ArgumentParser(
        prog="gstbad-launch",
        description="Run a gst-launch style pipeline description on "
                    "the default JAX device (gst-launch-1.0 analog).")
    ap.add_argument("pipeline", nargs="+",
                    help="launch description, e.g. videotestsrc ! "
                         "solarize ! fakesink")
    ap.add_argument("-n", "--frames", type=int, default=64,
                    help="number of frames/buffers to run")
    ap.add_argument("-w", "--window", type=int, default=8)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print negotiated per-element specs "
                         "(gst-launch -v analog)")
    ap.add_argument("-m", "--messages", action="store_true",
                    help="print bus messages (gst-launch -m analog)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the default device")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from gstbad.core.pipeline import parse_launch
    from gstbad.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    desc = " ".join(args.pipeline)
    pipe = parse_launch(desc)
    print(f"Setting pipeline to PAUSED ... ({len(pipe.elements)} "
          "elements)", file=sys.stderr)
    pipe.negotiate()
    if args.verbose:
        for el in pipe.elements:
            spec = getattr(el, "out_spec", None)
            if spec is not None:
                print(f"  {el.NAME}: {spec}", file=sys.stderr)
    print("Setting pipeline to PLAYING ...", file=sys.stderr)
    t0 = time.perf_counter()
    outs = pipe.run(n_frames=args.frames, window=args.window)
    dt = time.perf_counter() - t0
    pipe.close()
    n = sum(o.batch for o in outs) if outs else 0
    if args.messages:
        for msg in pipe.bus.messages:
            print(f"  message: {msg.element} {msg.name} "
                  f"pts={msg.pts} {msg.fields}", file=sys.stderr)
    print(f"Got EOS from element \"pipeline0\".", file=sys.stderr)
    print(f"Execution ended after {dt:.3f}s — {n} buffers"
          + (f" ({n / dt:.1f}/s)" if dt > 0 and n else ""),
          file=sys.stderr)
    return 0


def transcode_main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gstbad-transcode",
        description="Transcode a y4m file through a gst-launch style "
                    "filter chain on the default JAX device "
                    "(gst-transcoder analog).")
    ap.add_argument("src")
    ap.add_argument("dest")
    ap.add_argument("--filters", default="",
                    help="gst-launch style filter chain")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--profile", default="y4m",
                    help="encoding profile: y4m[:FMT] | pnm | gdp | "
                         "hevc[:qp=N|:lossless] (real libx265) | "
                         "av1[:bitrate=N] (real libaom, IVF)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the default device")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from gstbad.session import Transcoder
    from gstbad.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    def progress(pos, total):
        pct = 100.0 * pos / total if total else 0.0
        print(f"\rposition {pos / 1e9:.2f}s / {total / 1e9:.2f}s "
              f"({pct:.0f}%)", end="", file=sys.stderr)

    t = Transcoder(args.src, args.dest, args.filters, window=args.window,
                   profile=args.profile, on_position=progress)
    frames = t.run()
    print(f"\nwrote {frames} frames to {args.dest}", file=sys.stderr)
    return 0
