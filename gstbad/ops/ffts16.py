"""Device-side gst_fft_s16 — BIT-EXACT kissfft FIXED_POINT=16.

Round 2 modeled only the aggregate fixed-point scale over XLA's float
rfft; this now runs the actual integer butterfly pipeline
(ops/kissfft_s16.py): each radix stage is one vectorized int32 pass over
the whole window, so the per-frame scalar butterfly walk of the C
becomes a handful of batched VPU ops and the spectra match gst_fft_s16
bit for bit."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from gstbad.golden.ffts16 import fft_scale, kf_factor  # noqa: F401


@lru_cache(maxsize=None)
def _hamming_f64(n: int):
    return np.asarray(0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n))


def window_hamming(s16: jnp.ndarray) -> jnp.ndarray:
    """Batched gst_fft_s16_window HAMMING: [..., N] i16-valued ->
    windowed i16 values (C (gint16) truncation)."""
    w = jnp.asarray(_hamming_f64(s16.shape[-1]))
    return jnp.trunc(s16.astype(jnp.float64) * w).astype(jnp.int32)


def fft_s16(s16: jnp.ndarray):
    """Batched [..., nfft] int-valued -> (real, imag) int32 pairs
    [..., nfft/2+1] — the BIT-EXACT kissfft FIXED_POINT=16 pipeline
    (ops/kissfft_s16.py), vectorized per radix stage over the window."""
    from gstbad.ops import kissfft_s16
    return kissfft_s16.kiss_fftr_s16(jnp, s16, s16.shape[-1])
