"""Separable gaussian blur with border-truncated normalization —
the JAX rebuild of gaussian_smooth (gst/gaudieffects/gstgaussblur.c:260-356).

The C code runs two float passes with per-position kernel windows clipped to
the frame and normalized by the partial kernel sum.  Zero-padded depthwise
convolution divided by the precomputed per-position partial sums reproduces
that exactly (padding contributes 0 to the numerator, and the denominator is
the same prefix-sum difference the C uses).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gstbad.golden.gaudieffects import gaussian_kernel


def border_sums(n: int, kern: np.ndarray, ksum: np.ndarray) -> np.ndarray:
    """Per-position normalization sums (gstgaussblur.c:268-276,319-321)."""
    window = kern.shape[0]
    center = window // 2
    out = np.empty(n, np.float32)
    for c in range(n):
        kmin = max(0, center - c)
        base = c - center + kmin
        kmax = min(window, n - base)
        out[c] = ksum[kmax - 1] - (ksum[kmin - 1] if kmin else np.float32(0))
    return out


def make_blur_tables(sigma: float, height: int, width: int):
    """Host-side precompute: (kernel f32 [window], row_sums [H], col_sums [W])."""
    kern, ksum = gaussian_kernel(sigma)
    return kern, border_sums(height, kern, ksum), border_sums(width, kern, ksum)


def gaussian_blur(img: jnp.ndarray, kern, row_sums: jnp.ndarray,
                  col_sums: jnp.ndarray) -> jnp.ndarray:
    """[B, H, W, C] uint8 -> uint8 (see _blur_reference): the GPU kernel
    or the plain XLA reference, by backend (_use_kernel)."""
    kern_np = np.asarray(kern)
    if _use_kernel(kern_np.shape[0] // 2):
        c = img.shape[-1]
        return _blur_pallas(img, tuple(float(k) for k in kern_np),
                            jnp.asarray(np.repeat(np.asarray(col_sums), c)),
                            row_sums)
    return _blur_reference(img, kern_np, row_sums, col_sums)


def _blur_reference(img: jnp.ndarray, kern, row_sums: jnp.ndarray,
                    col_sums: jnp.ndarray) -> jnp.ndarray:
    """[B, H, W, C] uint8 -> uint8; matches the C two-pass order:
    x-blur (divide by col sums), y-blur (divide by row sums), +0.5, clamp,
    truncating uint8 cast.

    Layout: the channel axis folds into the minor dimension ([B, H, W*C])
    so vector lanes see W*C contiguous floats instead of a C=4-lane
    channel-minor tail; an x-shift of `off` pixels is a roll of C*off
    lanes.  The arithmetic sequence per element is IDENTICAL to the
    unfolded form (same rolls, masks and FMA order), so results are
    bit-identical — only the vreg occupancy changes (4/128 -> full)."""
    kern_np = np.asarray(kern)
    b, h, w, c = img.shape
    window = kern_np.shape[0]
    center = window // 2
    x = img.astype(jnp.float32).reshape(b, h, w * c)
    # pad + static slices instead of rolls: the zero padding IS the
    # border mask (out-of-range taps contribute exactly 0.0), and XLA
    # fuses slice-of-pad into the FMA chain where the roll form
    # materialized one full-window buffer per tap (OOM at w32 1080p)
    xp = jnp.pad(x, ((0, 0), (0, 0), (center * c, center * c)))
    acc = jnp.zeros_like(x)
    for k in range(window):
        acc = acc + np.float32(kern_np[k]) \
            * lax.slice_in_dim(xp, k * c, k * c + w * c, axis=2)
    tmp = acc / jnp.asarray(np.repeat(np.asarray(col_sums), c)
                            )[None, None, :]
    tp = jnp.pad(tmp, ((0, 0), (center, center), (0, 0)))
    acc2 = jnp.zeros_like(tmp)
    for k in range(window):
        acc2 = acc2 + np.float32(kern_np[k]) \
            * lax.slice_in_dim(tp, k, k + h, axis=1)
    out = acc2 / row_sums[None, :, None]
    return jnp.clip(out + 0.5, 0.0, 255.0).astype(jnp.uint8
                                                  ).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# The GPU kernel (Pallas through Triton)
# ---------------------------------------------------------------------------
# gaussian_blur above writes its float32 x-pass to device memory and reads
# it back for the y-pass.  Here one program owns a band of _ROWS output
# rows x _LANES lanes of one frame (the [H, W*C] folded layout) and walks
# the input rows of that band plus its halo: each row is x-blurred as it
# arrives (its taps are lane-shifted reloads of the same cached row) and
# the last `window` x-blurred rows ride the loop carry, so each output
# row is the y-sum of the carry.  Device memory sees the u8 input once
# (plus the halo rows) and the u8 output once.  The arithmetic is
# gaussian_blur's, term for term.

_ROWS = 32
_LANES = 1024
KERNEL_MAX_CENTER = 8   # the carry holds 2 * center + 1 rows


def _use_kernel(center: int) -> bool:
    """The blur op's one backend choice: the Triton kernel on a GPU (for
    kernel windows whose rows fit the loop carry), the plain XLA
    reference on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        return center <= KERNEL_MAX_CENTER
    if backend == "cpu":
        return False
    raise NotImplementedError(f"gaussian_blur: no implementation for "
                              f"backend {backend!r} (gpu or cpu)")


def _blur_kernel(img_ref, cs_ref, rs_ref, out_ref, *, kern, h, wc, c):
    i32 = jnp.int32
    window = len(kern)
    center = window // 2
    b = pl.program_id(0)
    r0 = pl.program_id(1) * _ROWS
    lanes = pl.program_id(2) * _LANES + lax.broadcasted_iota(
        i32, (_LANES,), 0)
    in_w = lanes < wc
    colsum = plgpu.load(cs_ref.at[lanes], mask=in_w, other=1.0)

    def body(j, win):
        row = r0 - center + j
        row_ok = (row >= 0) & (row < h)
        rowc = jnp.clip(row, 0, h - 1)
        acc = jnp.zeros((_LANES,), jnp.float32)
        for k in range(window):
            src = lanes + (k - center) * c
            x = plgpu.load(img_ref.at[b, rowc, src],
                           mask=in_w & (src >= 0) & (src < wc) & row_ok,
                           other=0).astype(jnp.float32)
            acc = acc + np.float32(kern[k]) * x
        win = win[1:] + (jnp.where(row_ok, acc / colsum, 0.0),)
        r = row - center
        acc2 = jnp.zeros((_LANES,), jnp.float32)
        for k in range(window):
            acc2 = acc2 + np.float32(kern[k]) * win[k]
        rowsum = plgpu.load(rs_ref.at[jnp.clip(r, 0, h - 1)])
        out = jnp.clip(acc2 / rowsum + 0.5, 0.0, 255.0).astype(jnp.uint8)
        plgpu.store(out_ref.at[b, jnp.clip(r, 0, h - 1), lanes], out,
                    mask=in_w & (j >= 2 * center) & (r < h))
        return win

    win = tuple(jnp.zeros((_LANES,), jnp.float32) for _ in range(window))
    lax.fori_loop(i32(0), i32(_ROWS + 2 * center), body, win)


@functools.partial(jax.jit, static_argnames=("kern", "interpret"))
def _blur_pallas(img, kern: tuple, colsum_lanes, row_sums,
                 interpret: bool = False):
    """gaussian_blur on the GPU: img [B, H, W, C] u8, kern the static
    window weights, colsum_lanes [W*C] f32 (col sums repeated per
    channel), row_sums [H] f32."""
    b, h, w, c = img.shape
    wc = w * c
    out = pl.pallas_call(
        functools.partial(_blur_kernel, kern=kern, h=h, wc=wc, c=c),
        out_shape=jax.ShapeDtypeStruct((b, h, wc), jnp.uint8),
        grid=(b, pl.cdiv(h, _ROWS), pl.cdiv(wc, _LANES)),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="gaussian_blur",
    )(img.reshape(b, h, wc), colsum_lanes, row_sums)
    return out.reshape(b, h, w, c)
