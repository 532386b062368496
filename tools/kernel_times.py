#!/usr/bin/env python3
"""Times each hot op at its benchmark graph's shape on the GPU: the plain
XLA version against the bytes it must move, and the hand-written kernel
against XLA, alone and end to end in its graph.

Every line is one JSON record naming the op, its shape, the median
milliseconds of `--reps` timed calls (each ending in block_until_ready,
after one warm-up call that compiles), and for XLA versions the byte
floor, the achieved GB/s over that floor and its share of the H100 SXM's
3.35 TB/s (NVIDIA data sheet).  The first and last lines name the device
and the card's power limit.

Usage: python tools/kernel_times.py [--reps N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def median_ms(fn, args, reps):
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def record(name, shape, ms, runs, floor_bytes=None, **extra):
    rec = {"op": name, "shape": shape, "median_ms": ms,
           "runs_ms": runs, **extra}
    if floor_bytes is not None:
        gbps = floor_bytes / (ms / 1e3) / 1e9
        rec.update(floor_bytes=floor_bytes, floor_gbps=gbps,
                   pct_of_hbm_peak=100 * gbps * 1e9 / HBM_BYTES_PER_S)
    print(json.dumps(rec), flush=True)


def graph_fps(name, window, reps, op, kernel):
    """End-to-end frames/s of a benchmark graph (bench.time_pipeline),
    with the op module's kernel choice forced to `kernel`."""
    import bench
    from gstbad.models import build

    keep = op._use_kernel
    op._use_kernel = lambda *a: kernel
    try:
        fps, runs = bench.time_pipeline(build(name), window, 2, warmup=1,
                                        reps=reps)
    finally:
        op._use_kernel = keep
    return fps, runs


def compare_graph(name, window, reps, op):
    """Kernel and XLA end to end in one graph, in turns."""
    for label, kernel in (("kernel", True), ("xla", False),
                          ("xla", False), ("kernel", True)):
        fps, runs = graph_fps(name, window, reps, op, kernel)
        print(json.dumps({"graph": name, "path": label, "window": window,
                          "fps": fps, "runs_fps": runs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    reps = args.reps

    import jax
    import jax.numpy as jnp

    from gstbad.golden import geometric as g_geo
    from gstbad.ops import audio as A
    from gstbad.ops import blur as blur_ops
    from gstbad.ops import chainfuse
    from gstbad.ops import comb
    from gstbad.ops import fieldanalysis as fa
    from gstbad.ops import lut
    from gstbad.ops.remap import fix_map, remap
    from gstbad.utils.compile_cache import enable_compile_cache
    from gstbad.utils.device import card_info, device_info

    if jax.default_backend() != "gpu":
        sys.exit("kernel_times: no GPU")
    enable_compile_cache()
    ctx = {"device": device_info(), "card": card_info()}
    print(json.dumps(ctx), flush=True)
    rng = np.random.default_rng(0)
    px = 1920 * 1080

    # 1 + 2: table chains (ten_element, config1/2): the whole fused step,
    # and the whole-word lookup alone.  Floor: the output write.
    import bench
    from gstbad.models import build
    for name, window in (("ten_element", 256), ("config1_sepia", 256),
                         ("config2_gaudi", 256)):
        fps, runs = bench.time_pipeline(build(name), window, 2, warmup=1,
                                        reps=reps)
        record(f"graph:{name}", [window, 1080, 1920, 4],
               window / fps * 1e3, [window / f * 1e3 for f in runs],
               floor_bytes=window * px * 4, fps=fps)
    compare_graph("ten_element", 256, reps, chainfuse)
    idx = jnp.asarray(rng.integers(0, 256, (256, 1080, 1920)), jnp.int32)
    table = jnp.asarray(rng.integers(0, 2 ** 31, 256), jnp.int32)
    ms, runs = median_ms(jax.jit(lut.apply_word_table), (idx, table), reps)
    record("apply_word_table (jnp.take)", list(idx.shape), ms, runs,
           floor_bytes=idx.size * 8)
    del idx

    # 3: gaussianblur sigma=1.2 on AYUV (config2_blur, window 128).
    # Floor: read + write of the u8 frames.
    img = jnp.asarray(rng.integers(0, 256, (128, 1080, 1920, 4),
                                   dtype=np.uint8))
    kern, rows, cols = blur_ops.make_blur_tables(1.2, 1080, 1920)
    ref = jax.jit(lambda x: blur_ops._blur_reference(
        x, kern, jnp.asarray(rows), cols))
    ker = jax.jit(lambda x: blur_ops._blur_pallas(
        x, tuple(float(k) for k in kern),
        jnp.asarray(np.repeat(cols, 4)), jnp.asarray(rows)))
    for label, fn in (("xla", ref), ("kernel", ker), ("kernel", ker),
                      ("xla", ref)):
        ms, runs = median_ms(fn, (img,), reps)
        record(f"gaussian_blur {label}", list(img.shape), ms, runs,
               floor_bytes=2 * img.size)
    a, b_ = np.asarray(ref(img[:4])), np.asarray(ker(img[:4]))
    print(json.dumps({"op": "gaussian_blur kernel vs xla", "max_abs_diff":
                      int(np.abs(a.astype(int) - b_.astype(int)).max())}),
          flush=True)
    del img
    compare_graph("config2_blur", 128, reps, blur_ops)

    # 4: fisheye remap (warp_1080p w32, warp_4k and config4 w16).
    # Floor: read + write of the frames, plus the i32 map once.
    for (h, w, b) in ((1080, 1920, 32), (2160, 3840, 16)):
        frames = jnp.asarray(rng.integers(0, 256, (b, h, w, 4),
                                          dtype=np.uint8))
        flat, valid = fix_map(g_geo.fisheye_map(w, h), w, h, "ignore")
        args_ = (frames, jnp.asarray(flat), jnp.asarray(valid),
                 jnp.zeros(4, jnp.uint8))
        ms, runs = median_ms(jax.jit(remap), args_, reps)
        record("remap fisheye", [b, h, w, 4], ms, runs,
               floor_bytes=2 * frames.size + 4 * h * w)
        del frames

    # 5: fieldanalysis's five default metrics over a 720p window.
    # Floor: one read of y and of prev.
    y = jnp.asarray(rng.integers(0, 256, (256, 720, 1280), dtype=np.uint8))
    prev = jnp.asarray(rng.integers(0, 256, (256, 720, 1280),
                                    dtype=np.uint8))
    nf = jnp.int32(16)

    def metrics(yi, pi):
        return (fa.opposite_parity_5_tap(yi, jnp.int32(0), yi, nf),
                fa.same_parity_ssd(yi, jnp.int32(0), pi, jnp.int32(0), nf),
                fa.same_parity_ssd(yi, jnp.int32(1), pi, jnp.int32(1), nf),
                fa.opposite_parity_5_tap(yi, jnp.int32(0), pi, nf),
                fa.opposite_parity_5_tap(yi, jnp.int32(1), pi, nf))

    ms, runs = median_ms(jax.jit(jax.vmap(metrics)), (y, prev), reps)
    record("fieldanalysis metrics (vmap)", list(y.shape), ms, runs,
           floor_bytes=2 * y.size)

    # 6: comb chain, mask mode (combdetect window 256).  Floor: read the
    # luma, write the u8 mask.
    luma = y.at[:, 1::2, 400:800].set(255)
    ref = jax.jit(lambda x: comb._mask_reference(x, 2, 2))
    ker = jax.jit(lambda x: comb._mask_kernel(x, 2, 2))
    for label, fn in (("xla", ref), ("kernel", ker), ("kernel", ker),
                      ("xla", ref)):
        ms, runs = median_ms(fn, (luma,), reps)
        record(f"comb_mask {label}", list(luma.shape), ms, runs,
               floor_bytes=2 * luma.size)
    del prev

    # 7: comb chain, score mode (ivtc window 256: CAP + 3*256 - 1 = 775
    # adjacent pairs over a pool of 264 frames).  Floor: one read of the
    # pool.
    pool = luma[:264] if luma.shape[0] >= 264 else jnp.concatenate(
        [luma, luma[:264 - luma.shape[0]]])
    ti = jnp.asarray(rng.integers(0, 264, 775), jnp.int32)
    bi = jnp.asarray(rng.integers(0, 264, 775), jnp.int32)
    ref = jax.jit(lambda p, t, b: comb._pairs_reference(p, t, b, 128))
    ker = jax.jit(lambda p, t, b: comb._comb_pallas(p, t, b))
    for label, fn in (("xla", ref), ("kernel", ker), ("kernel", ker),
                      ("xla", ref)):
        ms, runs = median_ms(fn, (pool, ti, bi), reps)
        record(f"comb_score_pairs {label}", [775, 720, 1280], ms, runs,
               floor_bytes=pool.size)
    del luma, pool, y

    # 6 + 7 end to end: the graphs with the kernel and with the XLA
    # reference, in turns
    for name in ("combdetect_720p", "config5_ivtc"):
        compare_graph(name, 256, reps, comb)

    # 8: VAD power chain (config3_audio window: 256 blocks of 4800).
    data = jnp.asarray(rng.integers(-32768, 32768, (256, 4800)), jnp.int16)
    sq = ((data.astype(jnp.int32) ** 2) >> 14) & 0xFFFF
    p0 = jnp.asarray([0, 1234], jnp.int32)
    ms, runs = median_ms(jax.jit(A._vad_powers_serial), (p0, sq), reps)
    record("vad serial fallback (fori_loop)", list(sq.shape), ms, runs)
    st = A.vad_init_state()
    f = jax.jit(lambda s, d: A.vad_window(s, d, jnp.int64(4294),
                                          jnp.int64(480)))
    ms, runs = median_ms(f, (st, data), reps)
    record("vad_window (bracket path)", list(data.shape), ms, runs)

    print(json.dumps(ctx), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
