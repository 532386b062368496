#!/usr/bin/env python3
"""Per-element cumulative profile of a filter chain on the current backend.

    python tools/profile_graph.py            # default 10-element 1080p graph
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

import gstbad as gt

CHAIN = ["coloreffects preset=sepia", "solarize", "chromium", "dodge",
         "burn", "exclusion", "dilate", "chromahold",
         "videoconvert format=AYUV", "zebrastripe"]
BASE = "videotestsrc pattern=bars width=1920 height=1080 format=BGRx ! "


def timep(desc, window=8, reps=6):
    p = gt.parse_launch(desc)
    p.negotiate()
    step = p.compile(window)
    params = p.params()
    states = p.init_states(window)
    states, leaf, _ = step(params, states, None)
    x = leaf[-1].data
    x = x["y"] if isinstance(x, dict) else x
    _ = np.asarray(x[0, 0, :2])  # force completion (fetch to host)
    t0 = time.perf_counter()
    for _i in range(reps):
        states, leaf, _ = step(params, states, None)
    x = leaf[-1].data
    x = x["y"] if isinstance(x, dict) else x
    _ = np.asarray(x[0, 0, :2])
    return (time.perf_counter() - t0) / reps


def main():
    prev = 0.0
    for i in range(len(CHAIN) + 1):
        desc = (BASE + " ! ".join(CHAIN[:i] + ["fakesink"]) if i
                else BASE + "fakesink")
        dt = timep(desc)
        name = CHAIN[i - 1] if i else "(source only)"
        print(f"{name:28s} cum {dt * 1e3:7.2f} ms/w8   "
              f"delta {(dt - prev) * 1e3:+7.2f} ms", flush=True)
        prev = dt


if __name__ == "__main__":
    main()
