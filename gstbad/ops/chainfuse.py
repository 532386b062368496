"""Fused chain kernel — the whole headline tail in ONE GPU pass.

The table-fusion pass (core/tablefuse.py) reduces a chain like
sepia!solarize!...!exclusion!dilate!chromahold!videoconvert!zebrastripe
to: idx = luma(src); idx' = dilate3(idx, rank[idx]); out =
word_table[idx'] with a positional stripe select.  As separate XLA
fusions that materializes the idx and rank planes and reads them back
for each shifted neighbour; this kernel (Pallas through Triton) runs the
entire tail per output tile:

  - each program owns a run of _PIXELS consecutive pixels of one frame
    and loads the source word of every pixel and of its down/right/left
    neighbours
    straight from the source frame (edge replication is a clamped
    coordinate; the reference's dead `up` pointer means no up neighbour,
    gstdilate.c:291-300),
  - luma (the traced index_fn), both 256-entry lookups (rank and final
    word, cache-resident gathers), the dilate3 walk and the zebra stripe
    select all happen in registers,
  - a static source (videotestsrc's [1, H, W] broadcast base) is read
    for every frame of the window from the one base frame.

Device memory sees the output write and the (cached) source once.
Everything is int32 (the package enables global x64).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_ZEBRA_KEEP = np.int32(np.uint32(0xFFFF00FF))  # clear the AYUV Y byte
_PIXELS = 1024   # pixels per program: a run of consecutive pixels of a frame


def _use_kernel() -> bool:
    """The fused tail's one backend choice: the Triton kernel on a GPU,
    the XLA table chain on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise NotImplementedError(f"chainfuse: no implementation for backend "
                              f"{backend!r} (gpu or cpu)")


def _kernel(src_ref, rkt_ref, wdt_ref, erode_ref, thr_ref, phase_ref,
            out_ref, *, h, w, index_fn, bcast):
    i32 = jnp.int32
    b = pl.program_id(0)
    pix = pl.program_id(1) * _PIXELS + lax.broadcasted_iota(
        i32, (_PIXELS,), 0)
    # pixels past the frame end (a padded last run) redo its last pixel;
    # their stores land in the padding, which the wrapper slices off
    flat = jnp.minimum(pix, h * w - 1)
    r = flat // w
    c = flat - r * w
    sb = 0 if bcast else b

    def idx_rank(rr, cc):
        word = plgpu.load(src_ref.at[sb, rr * w + cc])
        idx = index_fn(word).astype(i32)
        return idx, plgpu.load(rkt_ref.at[idx])

    out_i, out_k = idx_rank(r, c)
    erode = plgpu.load(erode_ref.at[b]) != 0
    # the reference's sequential down/right/left walk (gstdilate.c:273-350)
    for n_i, n_k in (idx_rank(jnp.minimum(r + 1, h - 1), c),
                     idx_rank(r, jnp.minimum(c + 1, w - 1)),
                     idx_rank(r, jnp.maximum(c - 1, 0))):
        take = jnp.where(erode, n_k < out_k, n_k > out_k)
        out_i = jnp.where(take, n_i, out_i)
        out_k = jnp.where(take, n_k, out_k)

    word = plgpu.load(wdt_ref.at[out_i])
    y = (word >> 8) & 255
    stripe = ((c + r + plgpu.load(phase_ref.at[b])) & 4) != 0
    zebra = (word & _ZEBRA_KEEP) | i32(16 << 8)
    out = jnp.where(stripe & (y >= plgpu.load(thr_ref.at[b])), zebra, word)
    plgpu.store(out_ref.at[b, pix], out)


def dilate_zebra_fused(src_word: jnp.ndarray, rank_table: jnp.ndarray,
                       word_table: jnp.ndarray, index_fn, erode, thr,
                       phase, interpret: bool = False,
                       batch: int | None = None) -> jnp.ndarray:
    """[B, H, W] i32 source words -> final AYUV words, one kernel.

    rank_table/word_table: [256] int32.  erode/thr/phase: scalars or
    per-frame [B].  index_fn: pure word -> index-in-[0,256) function
    traced into the kernel body.  src_word may be a broadcast base of
    shape [1, H, W] with batch=B (the videotestsrc static-pattern path).
    """
    sb, h, w = src_word.shape
    b = sb if batch is None else batch
    bcast = sb == 1 and b > 1

    def per_frame(v):
        return jnp.broadcast_to(jnp.asarray(v).astype(jnp.int32), (b,))

    runs = pl.cdiv(h * w, _PIXELS)
    out = pl.pallas_call(
        functools.partial(_kernel, h=h, w=w, index_fn=index_fn,
                          bcast=bcast),
        out_shape=jax.ShapeDtypeStruct((b, runs * _PIXELS), jnp.int32),
        grid=(b, runs),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="dilate_zebra",
    )(src_word.astype(jnp.int32).reshape(sb, h * w),
      rank_table.astype(jnp.int32), word_table.astype(jnp.int32),
      per_frame(erode), per_frame(thr), per_frame(phase))
    return out[:, :h * w].reshape(b, h, w)
