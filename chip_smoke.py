#!/usr/bin/env python3
"""Smoke test of gstbad on one GPU: the main path, every kept kernel and
the host path, each checked against the repo's references.

Phases, in order, all in this one process (the only one on the card):

  1. device   the JAX backend is a GPU; its platform, kind and count, and
              the card's name and power limit (nvidia-smi in a child);
  2. kernels  each hand-written kernel compiled for the card at its
              graph's real widths and compared once with its plain
              reference, then the tests marked `gpu`;
  3. graphs   the ten benchmark graphs (gstbad/models/benchmarks.py)
              through parse_launch -> negotiate -> compile -> run at their
              published sizes, two windows each (state crosses a window
              boundary), fetched to the host and compared with goldens;
  4. host     the transcode CLI on a generated 1080p I420 y4m, compared
              with a CPU run of the same chain.

`--four` runs only the multi-card path instead: Pipeline.compile(mesh=...)
on four GPUs, meshes (dp=4, sp=1) and (dp=2, sp=2), each compared with the
one-card run.

Any failed check raises and the script exits non-zero.  The last stdout
line, printed only when every phase passed, is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# The gates, each with its reason.
GATES = {
    "exact": "bit-exact: integer paths (table chains, warps, bayer, comb, "
             "ivtc) have one right answer",
    "lsb": "<= 1 LSB: float32 paths (gaussianblur, the audio chain) round "
           "to 8/16 bits, and another summation order can move a value "
           "across one rounding step",
    "ssim": "SSIM == 1.0: the telecine round trip (config 5) recovers "
            "every progressive frame exactly",
}

# frames (audio blocks) per window, as bench.py runs the graphs, capped
# by its WINDOW_CAPS
WINDOW = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def check_equal(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.sum(got != want)) if got.shape == want.shape
               else f"shape {got.shape} != {want.shape}")
        raise AssertionError(f"{what}: not bit-exact ({bad} differ; "
                             f"gate: {GATES['exact']})")


def check_lsb(got, want, what: str) -> None:
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    worst = int(np.abs(got - want).max()) if got.size else 0
    if worst > 1:
        raise AssertionError(f"{what}: off by {worst} (gate: "
                             f"{GATES['lsb']})")


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def _comb_luma(rng, n, h, w):
    """Luma frames with combing: noise plus a bright block on odd rows."""
    y = rng.integers(0, 200, (n, h, w), dtype=np.uint8)
    y[:, 1::2, w // 4:3 * w // 4] = 255
    return y


def phase_kernels(card: str, h: int = 720, w: int = 1280,
                  n_frames: int = 8, n_pairs: int = 128,
                  blur_hw=(1080, 1920), tail_hw=(1080, 1920),
                  gpu_tests: bool = True) -> None:
    import jax
    import jax.numpy as jnp

    from gstbad.golden import ivtc as g_ivtc
    from gstbad.ops import comb

    rng = np.random.default_rng(0)

    # comb chain, mask mode (combdetect; ivtc emission): frames of 720p,
    # rows 2..H-2 (R = H - 4 = 716), W = 1280
    luma = jnp.asarray(_comb_luma(rng, n_frames, h, w))
    kern = jax.jit(lambda x: comb._mask_kernel(x, 2, 2))
    t0 = time.perf_counter()
    compiled = kern.lower(luma).compile()
    log(f"kernel comb_chain[mask] {n_frames}x{h}x{w} (R={h - 4}): "
        f"compiled in {time.perf_counter() - t0:.3f} s; "
        f"memory {compiled.memory_analysis()}")
    over_k, score_k = compiled(luma)
    over_r, score_r = jax.jit(
        lambda x: comb._mask_reference(x, 2, 2))(luma)
    check_equal(over_k, over_r, "comb_chain[mask] vs _scan_rows")
    check_equal(score_k, score_r, "comb_chain[mask] score vs _scan_rows")

    # comb chain, score mode (ivtc's pair scores): one pair chunk
    pool = jnp.asarray(_comb_luma(rng, 32, h, w))
    top = jnp.asarray(rng.integers(0, 32, n_pairs), jnp.int32)
    bot = jnp.asarray(rng.integers(0, 32, n_pairs), jnp.int32)
    pairs = jax.jit(lambda p, t, b: comb._comb_pallas(p, t, b))
    t0 = time.perf_counter()
    compiled = pairs.lower(pool, top, bot).compile()
    log(f"kernel comb_chain[score] {n_pairs} pairs of {h}x{w}: compiled "
        f"in {time.perf_counter() - t0:.3f} s; "
        f"memory {compiled.memory_analysis()}")
    s_k = np.asarray(compiled(pool, top, bot))
    s_r = np.asarray(jax.jit(lambda p, t, b: comb._pairs_reference(
        p, t, b, n_pairs))(pool, top, bot))
    check_equal(s_k, s_r, "comb_chain[score] vs the XLA reference")
    pool_np = np.asarray(pool)
    for i in range(2):   # the C recurrence itself, on two pairs
        want = g_ivtc.get_comb_score(pool_np[int(top[i])],
                                     pool_np[int(bot[i])])
        check_equal(s_k[i], want, f"comb_chain[score] pair {i} vs golden")
    log(f"kernels: comb_chain mask and score modes bit-exact vs the XLA "
        f"reference and the golden recurrence on {card}")

    # gaussianblur sigma=1.2 on AYUV frames (config2_blur), 1080p
    from gstbad.golden import gaudieffects as g_gaudi
    from gstbad.ops import blur

    bh, bw = blur_hw
    img = rng.integers(0, 256, (2, bh, bw, 4), dtype=np.uint8)
    kern, rows, cols = blur.make_blur_tables(1.2, bh, bw)
    f = jax.jit(lambda x: blur._blur_pallas(
        x, tuple(float(k) for k in kern), jnp.asarray(np.repeat(cols, 4)),
        jnp.asarray(rows)))
    t0 = time.perf_counter()
    compiled = f.lower(jnp.asarray(img)).compile()
    log(f"kernel gaussian_blur 2x{bh}x{bw}x4: compiled in "
        f"{time.perf_counter() - t0:.3f} s; "
        f"memory {compiled.memory_analysis()}")
    got = np.asarray(compiled(jnp.asarray(img)))
    ref = np.asarray(jax.jit(lambda x: blur._blur_reference(
        x, kern, jnp.asarray(rows), cols))(jnp.asarray(img)))
    check_lsb(got, ref, "gaussian_blur kernel vs the XLA reference")
    check_lsb(got[0], g_gaudi.gaussianblur(img[0], 1.2),
              "gaussian_blur kernel vs golden")
    log(f"kernels: gaussian_blur within 1 LSB of the XLA reference and "
        f"the golden on {card}")

    # the fused headline tail (ten_element): the whole graph step with
    # the kernel against the same step on the XLA table chain
    from gstbad.models import build
    from gstbad.ops import chainfuse

    def step_out(kernel: bool):
        keep = chainfuse._use_kernel
        chainfuse._use_kernel = lambda: kernel
        try:
            p = build("ten_element", width=tail_hw[1], height=tail_hw[0])
            p.negotiate()
            step = jax.jit(p.compile(8, jit=False))
            args = (p.params(), p.init_states(8), None)
            compiled = step.lower(*args).compile()
            return compiled, np.asarray(compiled(*args)[1][-1].data)
        finally:
            chainfuse._use_kernel = keep

    compiled, got = step_out(True)
    log(f"kernel dilate_zebra (ten_element step, 8x{tail_hw[0]}x"
        f"{tail_hw[1]}): memory {compiled.memory_analysis()}")
    check_equal(got, step_out(False)[1],
                "dilate_zebra step vs the XLA table chain")
    log(f"kernels: dilate_zebra bit-exact vs the XLA table chain on {card}")

    if gpu_tests:
        import pytest
        rc = pytest.main(["-q", "-m", "gpu", "--gpu", "-p",
                          "no:cacheprovider", os.path.join(HERE, "tests")])
        if rc != 0:
            raise AssertionError(f"tests marked gpu: pytest exit {rc}")


# ---------------------------------------------------------------------------
# phase 3: graphs
# ---------------------------------------------------------------------------


def _first_frame(launch: str) -> np.ndarray:
    """One frame of a static source, through the same element path."""
    from gstbad.core.pipeline import parse_launch
    out = parse_launch(launch + " ! fakesink").run(n_frames=1, window=1)
    return np.asarray(out[0].data[0])


def _windows(pipeline, window: int, n_windows: int = 2):
    """Run `n_windows` windows through Pipeline.run, one call each (the
    pipeline keeps its state between calls).  Returns the per-window
    host arrays and the per-window wall times."""
    outs, times = [], []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        batches = pipeline.run(n_frames=window, window=window)
        data = [np.asarray(b.data) for b in batches]
        times.append(time.perf_counter() - t0)
        outs.append(data[0] if len(data) == 1 else np.concatenate(data))
    return outs, times


def _ends(outs):
    """(window, index) of the first and last frame of each window."""
    return [(k, i) for k, o in enumerate(outs) for i in (0, len(o) - 1)]


def _video_src(graph: str, w: int, h: int) -> str:
    pattern, fmt = {
        "config1_sepia": ("bars", "BGRx"), "config2_gaudi": ("bars", "BGRx"),
        "config2_blur": ("bars", "AYUV"), "ten_element": ("bars", "BGRx"),
        "warp_1080p": ("bars", "BGRx"), "warp_4k": ("bars", "BGRx"),
        "config4_warp": ("gradient", "ARGB")}[graph]
    return (f"videotestsrc pattern={pattern} width={w} height={h} "
            f"format={fmt}")


def check_video_static(graph, outs, w, h):
    """Graphs fed by a static test pattern: every output frame is the
    golden of that one source frame (zebrastripe adds its phase)."""
    from gstbad.golden import bayer as g_bayer
    from gstbad.golden import gaudieffects as g_gaudi
    from gstbad.golden import geometric as g_geo
    from gstbad.models import benchmarks as bm

    src = _first_frame(_video_src(graph, w, h))
    window = len(outs[0])
    if graph == "config1_sepia":
        want = bm.config1_golden(src[None])[0]
    elif graph == "config2_gaudi":
        want = bm.config2_golden(src[None])[0]
    elif graph == "config2_blur":
        want = g_gaudi.gaussianblur(src, 1.2)
    elif graph in ("warp_1080p", "warp_4k"):
        want = g_geo.remap(src, g_geo.fisheye_map(w, h), "ignore")
    elif graph == "config4_warp":
        rgb = g_bayer.bayer2rgb(g_bayer.rgb2bayer(src, "bggr"), "bggr",
                                "ARGB")
        want = g_geo.remap(g_geo.remap(rgb, g_geo.fisheye_map(w, h)),
                           g_geo.twirl_map(w, h))
    for k, i in _ends(outs):
        got = outs[k][i]
        what = f"{graph} window {k} frame {i}"
        if graph == "ten_element":
            # AYUV out; the golden chain ends in the luma plane
            check_equal(got[..., 1], bm.ten_element_golden(
                src, k * window + i), what)
        elif graph == "config2_blur":
            check_lsb(got, want, what)
        else:
            check_equal(got, want, what)


def check_combdetect(outs, w, h, window):
    """combdetect paints the comb mask of its input, the interlaced
    stream.  The interlace stage alone, run through the compiled step,
    gives each output slot's input frame and validity; combdetect's
    zebra phase z counts slots from 1."""
    from gstbad.core.pipeline import parse_launch
    from gstbad.golden import ivtc as g_ivtc

    p = parse_launch(f"videotestsrc pattern=ball width={w} height={h} "
                     "format=GRAY8 framerate=24/1 ! interlace pattern=2:3 "
                     "! fakesink")
    p.negotiate()
    step = p.compile(window)
    states, params = p.init_states(window), p.params()
    slot0 = 0
    for k, got in enumerate(outs):
        states, leaves, _ = step(params, states, None)
        frames = np.asarray(leaves[-1].data)
        valid = np.flatnonzero(np.asarray(leaves[-1].valid))
        if len(valid) != len(got):
            raise AssertionError(f"combdetect window {k}: {len(got)} "
                                 f"frames out, {len(valid)} valid inputs")
        for i in (0, len(got) - 1):
            s = int(valid[i])
            want = g_ivtc.combdetect_y(frames[s], slot0 + s + 1)
            check_equal(got[i], want, f"combdetect window {k} frame {i}")
        slot0 += frames.shape[0]


def check_audio(outs, window):
    """config 3 (mixmatrix -> freeverb -> downmix to S16 -> removesilence,
    which passes every block with its default remove=false).  The golden
    chain runs from a fresh state over the first blocks; every block of
    both windows is compared with the same graph run on the CPU device."""
    import jax

    from gstbad.core.pipeline import parse_launch
    from gstbad.golden import audio as g_audio
    from gstbad.models import build

    n_gold = 4
    src = parse_launch(
        "audiotestsrc wave=sine channels=8 format=F32 samplesperbuffer=4800"
        " ! fakesink").run(n_frames=n_gold, window=n_gold)
    x = np.concatenate([np.asarray(b.data) for b in src]).reshape(-1, 8)
    matrix = np.full((2, 8), 0.125)
    matrix[0, 0] = matrix[1, 1] = 1.0
    mixed = g_audio.mixmatrix_f32(x, matrix)
    wet = g_audio.Freeverb(48000).process_stereo_float(mixed)
    mono = wet.astype(np.float64) @ np.array([0.5, 0.5])
    want = np.clip(np.round(mono * 32768.0), -32768, 32767)
    got = outs[0][:n_gold].reshape(-1)
    check_lsb(got, want, f"config3_audio first {n_gold} blocks vs golden")

    with jax.default_device(jax.devices("cpu")[0]):
        cpu_outs, _ = _windows(build("config3_audio"), window)
    for k, (g, c) in enumerate(zip(outs, cpu_outs)):
        check_lsb(g, c, f"config3_audio window {k} vs the CPU device")


def check_ivtc(outs, w, h):
    """config 5: emitted frames are whole progressive frames, and the
    telecine round trip scores SSIM 1.0 against the source."""
    sys.path.insert(0, HERE)
    import bench

    for k, o in enumerate(outs):
        if o.ndim != 3 or o.shape[1:] != (h, w) or o.dtype != np.uint8:
            raise AssertionError(f"config5_ivtc window {k}: got "
                                 f"{o.shape} {o.dtype}")
    fid = bench.config5_fidelity(w, h, n_frames=120, window=60)
    if fid["ssim"] != 1.0:
        raise AssertionError(f"config5_ivtc SSIM {fid} (gate: "
                             f"{GATES['ssim']})")
    return fid


GRAPHS = {
    # name: (width, height)
    "ten_element": (1920, 1080),
    "config1_sepia": (1920, 1080),
    "config2_gaudi": (1920, 1080),
    "config2_blur": (1920, 1080),
    "warp_1080p": (1920, 1080),
    "config4_warp": (3840, 2160),
    "warp_4k": (3840, 2160),
    "config5_ivtc": (1280, 720),
    "combdetect_720p": (1280, 720),
    "config3_audio": (None, None),
}


def run_graph(name: str, card: str, window: int, size=None) -> None:
    from gstbad.models import build

    w, h = size or GRAPHS[name]
    kw = {} if w is None else {"width": w, "height": h}
    p = build(name, **kw)
    p.negotiate()
    outs, times = _windows(p, window)
    for k, o in enumerate(outs):
        if o.dtype.kind == "f" and not np.isfinite(o).all():
            raise AssertionError(f"{name} window {k}: non-finite output")
    extra = ""
    if name == "combdetect_720p":
        check_combdetect(outs, w, h, window)
    elif name == "config3_audio":
        check_audio(outs, window)
    elif name == "config5_ivtc":
        extra = f", fidelity {check_ivtc(outs, w, h)}"
    else:
        check_video_static(name, outs, w, h)
    shape = "48 kHz x8 ch, 4800-sample blocks" if w is None else f"{w}x{h}"
    log(f"graph {name} {shape} window {window}: first window "
        f"{times[0]:.3f} s (compile included), second window "
        f"{times[1]:.3f} s, {sum(len(o) for o in outs)} outputs, golden "
        f"ok{extra}; card {card}")


def phase_graphs(card: str) -> None:
    sys.path.insert(0, HERE)
    from bench import WINDOW_CAPS

    for name in GRAPHS:
        run_graph(name, card, min(WINDOW, WINDOW_CAPS.get(name, WINDOW)))


# ---------------------------------------------------------------------------
# phase 4: host path
# ---------------------------------------------------------------------------


def phase_host(card: str, w: int = 1920, h: int = 1080,
               n_frames: int = 16) -> None:
    from gstbad.cli import transcode_main
    from gstbad.core.spec import MediaSpec
    from gstbad.io import y4m

    chain = "videoconvert format=AYUV ! gaussianblur ! videoconvert format=I420"
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        y4m.write_y4m(
            src, MediaSpec(kind="video", format="I420", width=w, height=h),
            {"y": rng.integers(0, 256, (n_frames, h, w), dtype=np.uint8),
             "u": rng.integers(0, 256, (n_frames, h // 2, w // 2),
                               dtype=np.uint8),
             "v": rng.integers(0, 256, (n_frames, h // 2, w // 2),
                               dtype=np.uint8)})
        out_gpu = os.path.join(tmp, "gpu.y4m")
        out_cpu = os.path.join(tmp, "cpu.y4m")
        t0 = time.perf_counter()
        rc = transcode_main([src, out_gpu, "--filters", chain])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"transcode on the GPU: exit {rc}")
        # the CPU run is a child process that never opens the card
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable,
                        os.path.join(HERE, "tools", "gstbad_transcode.py"),
                        src, out_cpu, "--filters", chain, "--cpu"],
                       env=env, check=True, timeout=900)
        with open(out_gpu, "rb") as f:
            a = np.frombuffer(f.read(), np.uint8)
        with open(out_cpu, "rb") as f:
            b = np.frombuffer(f.read(), np.uint8)
        # the y4m headers and both videoconverts are integer; gaussianblur
        # is a float32 path, where the GPU contracts multiply-adds that
        # the CPU rounds twice: that gate is 1 LSB
        check_lsb(a, b, "transcode y4m, GPU vs CPU")
    log(f"host: transcode {n_frames} frames {w}x{h} I420 through '{chain}' "
        f"in {dt:.3f} s; vs the CPU run {int(np.sum(a != b))} of {a.size} "
        f"bytes differ, each by 1 LSB at most; card {card}")


# ---------------------------------------------------------------------------
# --four: the mesh path
# ---------------------------------------------------------------------------


def phase_four(devices, w: int = 1920, h: int = 1080, iw: int = 1280,
               ih: int = 720, window: int = 8) -> None:
    from gstbad.core.pipeline import parse_launch
    from gstbad.models import build
    from gstbad.parallel import make_mesh

    graphs = {
        "ten_element": lambda: build("ten_element", width=w, height=h),
        "interlace ! ivtc": lambda: parse_launch(
            f"videotestsrc pattern=ball width={iw} height={ih} "
            "format=GRAY8 framerate=24/1 ! interlace pattern=2:3 ! ivtc "
            "! fakesink"),
    }
    for name, make in graphs.items():
        def run(mesh):
            p = make()
            p.negotiate()
            p.compile(window, mesh=mesh)
            t0 = time.perf_counter()
            res = p.run(n_frames=2 * window, window=window)
            dt = time.perf_counter() - t0
            return np.concatenate([np.asarray(b.data) for b in res]), dt

        want, dt1 = run(None)
        log(f"four: {name} one card: {want.shape[0]} frames in "
            f"{dt1:.3f} s (compile included)")
        for dp, sp in ((4, 1), (2, 2)):
            mesh = make_mesh(dp=dp, sp=sp, devices=devices)
            with mesh:
                got, dt = run(mesh)
            check_equal(got, want, f"{name} mesh dp={dp} sp={sp} vs one "
                                   "card")
            log(f"four: {name} mesh dp={dp} sp={sp}: bit-exact vs one "
                f"card, {got.shape[0]} frames in {dt:.3f} s (compile "
                "included)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh path, on four GPUs")
    args = ap.parse_args()

    import jax

    from gstbad.utils.compile_cache import enable_compile_cache
    from gstbad.utils.device import card_info, device_info

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {backend!r})",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    dev = device_info()
    card = card_info()
    log(f"device: {dev}; card: {card}; compile cache {cache}")

    if args.four:
        if dev["count"] != 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {dev['count']}",
                  file=sys.stderr)
            return 1
        phase_four(jax.devices())
    else:
        phase_kernels(card)
        phase_graphs(card)
        phase_host(card)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
