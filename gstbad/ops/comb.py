"""Comb detection — the ivtc/combdetect run-length comb metric
(gst/ivtc/gstivtc.c:634-680, gstcombdetect.c:215-260) vectorized.

The C walks rows carrying `thisline[]`: outlier cells accumulate
thisline[i] += thisline[i-1] + 1 (clamped at 1000), non-outliers reset to 0,
and cells > 100 score.  Within a row that is a SEGMENTED PREFIX SUM of
(prev_row + 1) over outlier runs, so each row is one cumsum + cummax;
rows chain sequentially.  The 1000-clamp is applied to the carried row
only — since every clamped value is > 100 either way, the painted cells and
the score are exactly the C's (clamping below 1000 never alters the > 100
test), while the unclamped in-row sums stay well inside int32.

Two implementations of the one recurrence, picked by `_use_kernel`:

  - `_scan_rows` (plain XLA, the reference): rows in blocks of `_BLOCK`
    unrolled rows per `lax.scan` step, batched over leading axes;
  - `_comb_pallas` (Pallas through Triton, the GPU path): one program per
    chain (frame or woven field pair) walks the rows with the carried row
    in registers, reading the luma rows straight from the frame pool — no
    staged outlier mask and no per-pair frame gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BLOCK = 32


def _use_kernel() -> bool:
    """The comb op's one backend choice: the Triton kernel on a GPU, the
    plain XLA reference on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise NotImplementedError(f"comb: no implementation for backend "
                              f"{backend!r} (gpu or cpu)")


def _outlier(s1, s2, s3):
    """src2 < min(src1,src3) - 5 or > max + 5 (int math)."""
    a = s1.astype(jnp.int32)
    b = s2.astype(jnp.int32)
    c = s3.astype(jnp.int32)
    return (b < jnp.minimum(a, c) - 5) | (b > jnp.maximum(a, c) + 5)


def _seg_cumsum(v, m):
    """In-run inclusive prefix sum: cumsum of v (v == 0 outside runs)
    minus the running total at the last run boundary.  v >= 0 keeps the
    plain cumsum monotone, so that boundary total is a cummax of the
    masked cumsum."""
    s = jnp.cumsum(v, axis=-1)
    base = lax.cummax(jnp.where(m, 0, s), axis=v.ndim - 1)
    return jnp.where(m, s - base, 0)


def _scan_rows(m):
    """Chain the thisline recurrence over the row axis of m [..., R, W]
    in blocks of _BLOCK unrolled rows per scan step.

    Per row r the C recurrence is t_r = segcumsum(t_{r-1} + 1 over runs)
    = runpos_r + segcumsum(t_{r-1} * m_r), where runpos (the 1-based
    position within each outlier run) has NO cross-row dependency and is
    precomputed for ALL rows in one vectorized pass; only the carried
    t part chains.  Returns the over-100 mask [..., R, W]."""
    r, w = m.shape[-2], m.shape[-1]
    lead = m.shape[:-2]
    nb = -(-r // _BLOCK)
    pad = nb * _BLOCK - r
    if pad:
        # padded rows are non-outliers: they reset the carry and score 0
        m = jnp.concatenate(
            [m, jnp.zeros(lead + (pad, w), bool)], axis=-2)
    runpos = _seg_cumsum(m.astype(jnp.int32), m)            # [..., R', W]
    # scan axis must lead: [nb, ..., BLOCK, W]
    mb = jnp.moveaxis(m.reshape(lead + (nb, _BLOCK, w)), -3, 0)
    rb = jnp.moveaxis(runpos.reshape(lead + (nb, _BLOCK, w)), -3, 0)

    def step(p, inp):
        mblk, rblk = inp
        overs = []
        for i in range(_BLOCK):
            mi = mblk[..., i, :]
            seg = rblk[..., i, :] + _seg_cumsum(jnp.where(mi, p, 0), mi)
            p = jnp.minimum(seg, 1000)
            overs.append(seg > 100)
        return p, jnp.stack(overs, axis=-2)

    _, over = lax.scan(step, jnp.zeros(lead + (w,), jnp.int32), (mb, rb))
    over = jnp.moveaxis(over, 0, -3).reshape(lead + (nb * _BLOCK, w))
    return over[..., :r, :]


# ---------------------------------------------------------------------------
# The GPU kernel (Pallas through Triton)
# ---------------------------------------------------------------------------
# Program i owns chain i: woven frame rows come from pool[top[i]] (even
# rows) and pool[bot[i]] (odd rows).  Per row it computes the outlier mask
# from the three rows around it, then the segmented prefix sum as
#     seg[c] = S[c] - S[L(c)],  S = cumsum(where(m, p + 1, 0)),
# with L(c) the last non-outlier column <= c.  Triton has no cummax, so
# L comes from one cumsum of the boundary flags plus a scatter/gather
# through a per-chain scratch row: boundary number k stores its column at
# pos[k - 1], and column c reads pos[count(c) - 1].  S takes the same
# round trip for S[L(c)].  Two scratch slots alternate by row, so one
# block barrier per row orders every store before the loads that read it
# (and the loads of row j before the stores of row j + 2).  All arithmetic
# is int32: the package enables x64 globally.


def _comb_kernel(pool_ref, top_ref, bot_ref, score_ref, s_ref, pos_ref,
                 *rest, h, w, wp, j_start, rows, emit_mask, barrier):
    i32 = jnp.int32
    over_ref = rest[0] if emit_mask else None
    c = pl.program_id(0)
    t = plgpu.load(top_ref.at[c])
    b = plgpu.load(bot_ref.at[c])
    cols = lax.broadcasted_iota(i32, (wp,), 0)
    in_w = cols < w

    def load_row(k):
        src = jnp.where((k & 1) == 0, t, b)
        return plgpu.load(pool_ref.at[src, k, cols], mask=in_w,
                          other=0).astype(i32)

    def body(j, carry):
        above, here, below, p, acc = carry
        k = j_start + j
        # prefetch the row after next; the clamp keeps the address in the
        # frame on the last rows (that row is then never used)
        ahead = load_row(jnp.minimum(k + 2, i32(h - 1)))
        m = in_w & ((here < jnp.minimum(above, below) - 5)
                    | (here > jnp.maximum(above, below) + 5))
        bnd = jnp.logical_not(m)
        cnt = lax.cumsum(bnd.astype(i32), axis=0)
        s = lax.cumsum(jnp.where(m, p + 1, 0), axis=0)
        slot = j & 1
        plgpu.store(s_ref.at[c, slot, cols], s)
        # masked-off lanes aim at the unread upper half, so no two lanes
        # of the scatter share an address
        plgpu.store(pos_ref.at[c, slot, jnp.where(bnd, cnt - 1, wp + cols)],
                    cols, mask=bnd)
        if barrier:
            plgpu.debug_barrier()
        last = plgpu.load(pos_ref.at[c, slot, jnp.maximum(cnt - 1, 0)],
                          mask=cnt > 0, other=-1)
        base = plgpu.load(s_ref.at[c, slot, jnp.maximum(last, 0)],
                          mask=last >= 0, other=0)
        seg = jnp.where(m, s - base, 0)
        over = seg > 100
        if emit_mask:
            plgpu.store(over_ref.at[c, j, cols], over.astype(jnp.uint8),
                        mask=in_w)
        return (here, below, ahead, jnp.minimum(seg, 1000),
                acc + over.astype(i32))

    zero = jnp.zeros((wp,), i32)
    carry = (load_row(i32(j_start - 1)), load_row(i32(j_start)),
             load_row(i32(j_start + 1)), zero, zero)
    acc = lax.fori_loop(i32(0), i32(rows), body, carry)[4]
    plgpu.store(score_ref.at[c], jnp.sum(acc, dtype=i32))


@functools.partial(jax.jit, static_argnames=("j_start", "j_stop_off",
                                             "emit_mask", "interpret"))
def _comb_pallas(pool, top, bot, j_start: int = 2, j_stop_off: int = 2,
                 emit_mask: bool = False, interpret: bool = False):
    """Comb chains over woven frames: chain i weaves pool[top[i]] (even
    rows) with pool[bot[i]] (odd rows) and scans rows [j_start,
    H - j_stop_off).  pool [P, H, W] u8, top/bot [n] i32.  Returns the
    scores [n] i32 and, with emit_mask, the over-100 mask [n, R, W]."""
    _, h, w = pool.shape
    n = top.shape[0]
    rows = h - j_start - j_stop_off
    if pool.size >= 2 ** 31:
        raise ValueError("comb: the frame pool must hold < 2**31 pixels "
                         "(int32 addressing)")
    wp = pl.next_power_of_2(w)
    out_shape = [jax.ShapeDtypeStruct((n,), jnp.int32),
                 jax.ShapeDtypeStruct((n, 2, wp), jnp.int32),
                 jax.ShapeDtypeStruct((n, 2, 2 * wp), jnp.int32)]
    if emit_mask:
        out_shape.append(jax.ShapeDtypeStruct((n, rows, w), jnp.uint8))
    outs = pl.pallas_call(
        functools.partial(_comb_kernel, h=h, w=w, wp=wp, j_start=j_start,
                          rows=rows, emit_mask=emit_mask,
                          # the interpreter runs one program at a time
                          # and has no barrier rule
                          barrier=not interpret),
        out_shape=out_shape,
        grid=(n,),
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(8, wp // 256))),
        interpret=interpret,
        name="comb_chain",
    )(pool, top.astype(jnp.int32), bot.astype(jnp.int32))
    return (outs[0], outs[3] != 0) if emit_mask else outs[0]


def _mask_reference(luma, j_start: int, j_stop_off: int):
    """The XLA reference for comb_mask: (over [..., R, W], score [...])."""
    h = luma.shape[-2]
    s1 = luma[..., j_start - 1:h - j_stop_off - 1, :]
    s2 = luma[..., j_start:h - j_stop_off, :]
    s3 = luma[..., j_start + 1:h - j_stop_off + 1, :]
    over = _scan_rows(_outlier(s1, s2, s3))
    return over, jnp.sum(over.astype(jnp.int32), axis=(-2, -1))


def _mask_kernel(luma, j_start: int, j_stop_off: int):
    """comb_mask's GPU path: (over [..., R, W], score [...])."""
    h, w = luma.shape[-2], luma.shape[-1]
    lead = luma.shape[:-2]
    n = 1
    for s in lead:
        n *= s
    ids = jnp.arange(n, dtype=jnp.int32)
    score, over = _comb_pallas(luma.reshape((n, h, w)), ids, ids,
                               j_start=j_start, j_stop_off=j_stop_off,
                               emit_mask=True)
    return over.reshape(lead + over.shape[1:]), score.reshape(lead)


def comb_mask(luma: jnp.ndarray, j_start: int = 2, j_stop_off: int = 2):
    """Per-pixel over-100 mask + score for rows [j_start, H - j_stop_off).

    luma: [..., H, W] uint8 (woven frames).  Returns (mask [..., H, W]
    bool with False outside the scanned band, score [...] int32).
    """
    impl = _mask_kernel if _use_kernel() else _mask_reference
    over, score = impl(luma, j_start, j_stop_off)
    h = luma.shape[-2]
    mask = jnp.zeros(luma.shape, bool)
    mask = mask.at[..., j_start:h - j_stop_off, :].set(over)
    return mask, score


def interleave(top: jnp.ndarray, bottom: jnp.ndarray) -> jnp.ndarray:
    """Even rows from `top`, odd rows from `bottom` (GET_LINE_IL)."""
    h = top.shape[-2]
    parity = (jnp.arange(h) % 2)[:, None]
    return jnp.where(parity == 0, top, bottom)


def comb_score(top: jnp.ndarray, bottom: jnp.ndarray) -> jnp.ndarray:
    """get_comb_score (gstivtc.c:634-680) on two field-source luma frames
    (batched over leading axes)."""
    return comb_mask(interleave(top, bottom))[1]


def _pairs_reference(pool_y, top_idx, bot_idx, chunk: int):
    """The XLA reference for comb_score_pairs.  It gathers the two frame
    sets, so it streams `chunk` pairs at a time (the last chunk padded
    with pair 0) to bound that staging."""
    n = top_idx.shape[0]
    k = -(-n // chunk)
    pad = k * chunk - n
    ti = jnp.pad(top_idx.astype(jnp.int32), (0, pad))
    bi = jnp.pad(bot_idx.astype(jnp.int32), (0, pad))

    def run(ids):
        t, b = ids
        return _mask_reference(interleave(pool_y[t], pool_y[b]), 2, 2)[1]

    scores = lax.map(run, (ti.reshape(k, chunk), bi.reshape(k, chunk)))
    return scores.reshape(k * chunk)[:n]


def comb_score_pairs(pool_y: jnp.ndarray, top_idx: jnp.ndarray,
                     bot_idx: jnp.ndarray, chunk: int = 128) -> jnp.ndarray:
    """get_comb_score for n (top, bottom) frame pairs out of a frame pool.

    pool_y: [P, H, W] u8.  top_idx/bot_idx: [n] i32 — the frame whose
    even/odd rows form the woven candidate (gstivtc.c:634-680).  The GPU
    kernel reads the pool rows in place, one program per pair; `chunk`
    bounds the XLA reference's per-step staging.
    """
    if pool_y.shape[-2] - 4 <= 0:
        return jnp.zeros(top_idx.shape[0], jnp.int32)
    if _use_kernel():
        return _comb_pallas(pool_y, top_idx, bot_idx)
    return _pairs_reference(pool_y, top_idx, bot_idx, chunk)
