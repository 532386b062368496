"""Audio DSP kernels: audiomixmatrix paths, the freeverb reverb scan, and
the removesilence VAD — exact rebuilds of the C semantics on device.

freeverb's sample-serial feedback (8 parallel combs + 4 series allpasses,
gstfreeverb.c:288-330) is the reference's hardest kernel for a batch machine
(SURVEY.md "hard parts" #1): it runs as a lax.scan over samples with the
delay lines as carried ring buffers indexed by sample count mod tuning.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# float32 contractions run at full f32 precision (never TF32/bf16 passes):
# the audio paths are gated at <= 2e-6 against f32/f64 references
_HIGHEST = lax.Precision.HIGHEST

# ---------------------------------------------------------------------------
# audiomixmatrix
# ---------------------------------------------------------------------------


def mix_f32(x: jnp.ndarray, matrix: jnp.ndarray) -> jnp.ndarray:
    """F32 path (gstaudiomixmatrix.c:436-457): f32 accumulate over inputs in
    channel order.  x: [..., S, in], matrix f64 [out, in] -> [..., S, out]."""
    acc = jnp.zeros(x.shape[:-1] + (matrix.shape[0],), jnp.float32)
    for i in range(matrix.shape[1]):
        acc = acc + x[..., i:i + 1] * matrix[:, i].astype(jnp.float32)[None, :]
    return acc


def mix_f64(x: jnp.ndarray, matrix: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...si,oi->...so", x.astype(jnp.float64), matrix,
                      precision=lax.Precision.HIGHEST).astype(jnp.float64)


def mix_s16(x: jnp.ndarray, conv: jnp.ndarray, shift: int) -> jnp.ndarray:
    """S16 fixed-point path (gstaudiomixmatrix.c:480-501) with C int32
    wraparound semantics; conv int32 [out, in]."""
    prod = (x.astype(jnp.int64)[..., None, :]
            * conv.astype(jnp.int64)[None, :, :]).astype(jnp.int32)
    acc = jnp.sum(prod.astype(jnp.int64), axis=-1).astype(jnp.int32)
    return (acc >> shift).astype(jnp.int16)


def mix_s32(x: jnp.ndarray, conv: jnp.ndarray, shift: int) -> jnp.ndarray:
    """S32 path (gstaudiomixmatrix.c:504-525); int64 wrap accumulate."""
    prod = x.astype(jnp.int64)[..., None, :] * conv[None, :, :]
    acc = jnp.sum(prod, axis=-1)
    return (acc >> shift).astype(jnp.int32)


def channelmix_s16(x: jnp.ndarray, ll, lr, rl, rr) -> jnp.ndarray:
    """audiochannelmix (gstaudiochannelmix.c:222-251): rint + clamp."""
    l = x[..., 0].astype(jnp.float64)
    r = x[..., 1].astype(jnp.float64)
    nl = jnp.clip(jnp.round(ll * l + rl * r), -32768, 32767)
    nr = jnp.clip(jnp.round(lr * l + rr * r), -32768, 32767)
    return jnp.stack([nl, nr], axis=-1).astype(jnp.int16)


# ---------------------------------------------------------------------------
# freeverb
# ---------------------------------------------------------------------------

DC_OFFSET = np.float32(1e-8)
COMB_L = np.array([1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617])
ALLPASS_L = np.array([556, 441, 341, 225])
STEREOSPREAD = 23


def freeverb_sizes(rate: int) -> Dict[str, np.ndarray]:
    srf = rate / 44100.0
    return {
        "combL": (COMB_L * srf).astype(np.int32),
        "combR": ((COMB_L + STEREOSPREAD) * srf).astype(np.int32),
        "apL": (ALLPASS_L * srf).astype(np.int32),
        "apR": ((ALLPASS_L + STEREOSPREAD) * srf).astype(np.int32),
    }


def freeverb_init_state(rate: int):
    s = freeverb_sizes(rate)
    cmax = int(max(s["combL"].max(), s["combR"].max()))
    amax = int(max(s["apL"].max(), s["apR"].max()))
    def dc(shape):  # distinct buffers: donated state must not alias
        return jnp.full(shape, DC_OFFSET, jnp.float32)
    return {
        "combL_buf": dc((8, cmax)), "combR_buf": dc((8, cmax)),
        "apL_buf": dc((4, amax)), "apR_buf": dc((4, amax)),
        "storeL": jnp.zeros(8, jnp.float32),
        "storeR": jnp.zeros(8, jnp.float32),
        "t": jnp.int32(0),
    }


def _comb_bank(buf, store, idx, inp, damp1, damp2, feedback):
    """One step of 8 parallel combs (freeverb_comb_process macro,
    gstfreeverb.c:277-287), vectorized across the bank."""
    rows = jnp.arange(8)
    tmp = buf[rows, idx]
    store = tmp * damp2 + store * damp1
    buf = buf.at[rows, idx].set(inp + store * feedback)
    return buf, store, tmp


def _allpass_chain(buf, idx, x):
    """4 series allpasses (freeverb_allpass_process, gstfreeverb.c:198-208),
    feedback fixed at 0.5 (gstfreeverb.c:520-529)."""
    for i in range(4):
        bufout = buf[i, idx[i]]
        out = bufout - x
        buf = buf.at[i, idx[i]].set(x + bufout * jnp.float32(0.5))
        x = out
    return buf, x


BLOCK = 128
_FIR_W = 128        # banded-solve taps (see _freeverb_process_fused)
_FIR_DAMP_MAX = 0.71  # damp1^_FIR_W <= 1e-19 below this


def freeverb_process(state, x: jnp.ndarray, params, rate: int, mono: bool):
    """Block-vectorized reverb.  x: [N] (mono) or [N, 2] f32 -> [N, 2].

    Every delay line is at least 225 samples (allpasstuningL4,
    gstfreeverb.c:323), so within a 128-sample block no read position was
    written in the same block: comb/allpass taps become contiguous circular
    slices of the pre-block buffers, the only true recurrence left is the
    comb damping one-pole (filterstore), computed as an associative scan,
    and the sample loop collapses to a scan over N/128 blocks instead of
    a per-sample scan; the float32 result differs from the C only by scan
    reassociation (<1e-4, within the 1e-3 gate).

    params: f32 scalars feedback, damp1, damp2, wet1, wet2, dry, gain
    (gst_freeverb_set_property, gstfreeverb.c:536-570).
    """
    if rate < 32000:
        return _freeverb_process_scan(state, x, params, rate, mono)
    sizes = freeverb_sizes(rate)
    dmax = int(max(sizes["combR"].max(), sizes["apR"].max()))
    if x.shape[0] >= dmax:
        return _freeverb_process_fused(state, x, params, rate, mono)
    return _freeverb_process_blocked(state, x, params, rate, mono)


def _ring_read(line, d: int, start):
    """BLOCK-long circular window of the d-length ring at the head of
    `line`, starting at `start` (< d).  The RING (line[:d], not the
    bank-padded line) is doubled so one dynamic_slice handles the wrap —
    no gather, which keeps compile time low (an advanced-index
    formulation compiles for minutes).
    d is a static host int, so all ring slicing below is static."""
    ring = line[:d]
    dbl = jnp.concatenate([ring, ring[:BLOCK]])
    return lax.dynamic_slice(dbl, (start,), (BLOCK,))


def _ring_write(line, d: int, start, vals, valid):
    """Write `vals` (masked by `valid`) into the same circular window."""
    ring = line[:d]
    dbl = jnp.concatenate([ring, ring[:BLOCK]])
    cur = lax.dynamic_slice(dbl, (start,), (BLOCK,))
    dbl = lax.dynamic_update_slice(dbl, jnp.where(valid, vals, cur),
                                   (start,))
    # fold the wrapped tail [d, d+BLOCK) back onto the ring head
    wrap = jnp.maximum(start + BLOCK - d, 0)
    head = jnp.where(jnp.arange(BLOCK) < wrap, dbl[d:d + BLOCK],
                     dbl[:BLOCK])
    ring = dbl[:d].at[:BLOCK].set(head)
    return line.at[:d].set(ring)


def _comb_bank_block(buf, store, t, sizes, inp, damp1, damp2, feedback,
                     valid, n_valid):
    """All 8 combs over one block.  buf [8, L], store [8], inp [BLOCK].
    sizes: host numpy delay lengths.  Returns (buf, store, out [BLOCK])."""
    starts = [jnp.remainder(t, int(d)).astype(jnp.int32) for d in sizes]
    tmp = jnp.stack([_ring_read(buf[i], int(d), starts[i])
                     for i, d in enumerate(sizes)])  # [8, BLOCK] taps

    # filterstore[s] = damp2*tmp[s] + damp1*filterstore[s-1]
    a = jnp.full((8, BLOCK), damp1, jnp.float32)
    b = tmp * damp2

    def compose(l, r):
        al, bl = l
        ar, br = r
        return al * ar, br + ar * bl

    _, stores = jax.lax.associative_scan(compose, (a, b), axis=1)
    # fold in the carried store: store[s] = stores[s] + damp1^(s+1)*store0
    powers = jnp.cumprod(a, axis=1)
    stores = stores + powers * store[:, None]
    new_vals = inp[None, :] + stores * feedback
    for i, d in enumerate(sizes):
        buf = buf.at[i].set(_ring_write(buf[i], int(d), starts[i],
                                        new_vals[i], valid))
    new_store = stores[jnp.arange(8), jnp.maximum(n_valid - 1, 0)]
    new_store = jnp.where(n_valid > 0, new_store, store)
    return buf, new_store, jnp.sum(tmp, axis=0)


def _allpass_chain_block(buf, t, sizes, x, valid):
    """4 series allpasses over one block.  buf [4, L], x [BLOCK]."""
    for i, d in enumerate(sizes):
        start = jnp.remainder(t, int(d)).astype(jnp.int32)
        bufout = _ring_read(buf[i], int(d), start)
        out = bufout - x
        buf = buf.at[i].set(_ring_write(
            buf[i], int(d), start, x + bufout * jnp.float32(0.5), valid))
        x = out
    return buf, x


def _freeverb_process_blocked(state, x, params, rate, mono):
    sizes = freeverb_sizes(rate)
    cL, cR = sizes["combL"], sizes["combR"]  # host ints: static ring caps
    aL, aR = sizes["apL"], sizes["apR"]
    damp1, damp2 = params["damp1"], params["damp2"]
    feedback = params["feedback"]
    wet1, wet2, dry = params["wet1"], params["wet2"], params["dry"]
    gain = params["gain"]

    n = x.shape[0]
    n_blocks = -(-n // BLOCK)
    pad = n_blocks * BLOCK - n
    if mono:
        xp = jnp.pad(x, (0, pad)).reshape(n_blocks, BLOCK)
        in2l = in2r = xp
        in1l = in1r = (jnp.float32(2.0) * xp + DC_OFFSET) * gain
    else:
        xp = jnp.pad(x, ((0, pad), (0, 0))).reshape(n_blocks, BLOCK, 2)
        in2l, in2r = xp[..., 0], xp[..., 1]
        in1l = (in2l + DC_OFFSET) * gain
        in1r = (in2r + DC_OFFSET) * gain
    base_valid = jnp.arange(BLOCK)

    def block_step(st, inp):
        i1l, i1r, i2l, i2r, bidx = inp
        t = st["t"]
        start = bidx * BLOCK
        n_valid = jnp.clip(n - start, 0, BLOCK).astype(jnp.int32)
        valid = base_valid < n_valid

        bufL, storeL, outl = _comb_bank_block(
            st["combL_buf"], st["storeL"], t, cL, i1l, damp1, damp2,
            feedback, valid, n_valid)
        bufR, storeR, outr = _comb_bank_block(
            st["combR_buf"], st["storeR"], t, cR, i1r, damp1, damp2,
            feedback, valid, n_valid)
        apL, outl = _allpass_chain_block(st["apL_buf"], t, aL, outl, valid)
        apR, outr = _allpass_chain_block(st["apR_buf"], t, aR, outr, valid)
        outl = outl - DC_OFFSET
        outr = outr - DC_OFFSET
        yl = outl * wet1 + outr * wet2 + i2l * dry
        yr = outr * wet1 + outl * wet2 + i2r * dry
        new = {"combL_buf": bufL, "combR_buf": bufR,
               "apL_buf": apL, "apR_buf": apR,
               "storeL": storeL, "storeR": storeR,
               "t": t + n_valid}
        return new, jnp.stack([yl, yr], axis=-1)

    bidx = jnp.arange(n_blocks, dtype=jnp.int32)
    state, y = lax.scan(block_step, state,
                        (in1l, in1r, in2l, in2r, bidx))
    return state, y.reshape(n_blocks * BLOCK, 2)[:n]


def _scan1(b: jnp.ndarray, coeff, y0, axis: int) -> jnp.ndarray:
    """y[t] = coeff * y[t-1] + b[t] with constant coeff and initial y[-1] =
    y0, as a log-depth associative scan along `axis`."""
    a = jnp.full(b.shape, coeff, jnp.float32)

    def compose(l, r):
        al, bl = l
        ar, br = r
        return al * ar, br + ar * bl

    _, y = jax.lax.associative_scan(compose, (a, b), axis=axis)
    powers = jnp.cumprod(a, axis=axis)
    y0 = jnp.asarray(y0, jnp.float32)
    if y0.ndim == b.ndim - 1:  # y0 = b minus the scan axis
        y0 = jnp.expand_dims(y0, axis)
    return y + powers * y0


def _lowtri_powers_T(coeff, n: int) -> jnp.ndarray:
    """Transposed lower-triangular power matrix: M[m, j] = coeff^(j-m) for
    j >= m else 0, built WITHOUT a gather:
    the classic tile/reshape Toeplitz trick — tiling a [2n] vector n times
    and reshaping to [n, 2n-1] shifts each row by one.

    y = scan1(b, coeff) becomes the matmul y = b @ M (+ the carried
    y0 term) — the per-block lag-1 recurrence stops being 11 serial
    associative-scan sweeps and becomes one 47 MFLOP matmul."""
    p = jnp.concatenate([jnp.ones((1,), jnp.float32),
                         jnp.cumprod(jnp.full((n - 1,), coeff, jnp.float32))])
    u = jnp.concatenate([jnp.zeros(n - 1, jnp.float32), p,
                         jnp.zeros(1, jnp.float32)])          # [2n]
    t = jnp.tile(u, n)[:n * (2 * n - 1)].reshape(n, 2 * n - 1)
    # t[i, k] = u[(k - i) mod 2n]  ->  t[m, j + n - 1] = coeff^(j-m)|tril
    return t[:, n - 1:]


def _ring_head(line, d: int, t0) -> jnp.ndarray:
    """The next d taps of a d-length ring: head[s] = ring[(t0+s) mod d]."""
    ring = line[:d]
    dbl = jnp.concatenate([ring, ring])
    return lax.dynamic_slice(dbl, (jnp.remainder(t0, d).astype(jnp.int32),),
                             (d,))


def _ring_store(line, d: int, t0_end, tail) -> jnp.ndarray:
    """Write the last d produced values back as the ring: tail[m] was
    produced at absolute time t0_end - d + m, which lives at ring position
    (t0_end + m) mod d — a circular rotation of `tail` by t0_end mod d."""
    st = jnp.remainder(t0_end, d).astype(jnp.int32)
    dbl = jnp.concatenate([tail, tail])
    ring = lax.dynamic_slice(dbl, (jnp.remainder(d - st, d),), (d,))
    return line.at[:d].set(ring)


def _freeverb_process_fused(state, x, params, rate, mono):
    """Whole-window reverb — the serial sample loop re-expressed as a
    handful of log-depth scans (VERDICT r2 #2: exploit linearity).

    Combs (freeverb_comb_process, gstfreeverb.c:277-287): the only true
    recurrence is filterstore[t] = damp1*filterstore[t-1]
    + damp2*(in[t-D] + feedback*filterstore[t-D]).  Processing in blocks of
    B = min(D) makes every lag-D read land in an ALREADY-COMPUTED earlier
    block; the per-block lag-1 solve is ONE matmul against the
    damp1-power Toeplitz matrix (_lowtri_powers_T) and the block walk is
    a lax.scan whose carry is a 2-block aligned history, so every lag-D
    read is a static per-row slice — the serial body is a matmul plus a
    fused copy pass instead of O(log B) sweep steps.

    Allpasses (freeverb_allpass_process, gstfreeverb.c:198-208): the buffer
    recurrence buf[t] = x[t] + 0.5*buf[t-D] has NO lag-1 term, so it
    decimates into D independent first-order recurrences ([N] -> [N/D, D],
    one associative scan along the block axis).

    Float32 result differs from the serial C only by scan reassociation
    (the allpass coefficient 0.5 is exact in binary); measured <= 2e-6 on
    0.8-amplitude noise.  Requires N >= max delay so the ring write-back
    covers every line; shorter windows use the blocked path.
    """
    sizes = freeverb_sizes(rate)
    D = np.concatenate([sizes["combL"], sizes["combR"]]).astype(int)  # [16]
    B = int(D.min())
    dmax = int(D.max())
    n = int(x.shape[0])
    K = -(-n // B)
    np_len = K * B

    damp1, damp2 = params["damp1"], params["damp2"]
    feedback = params["feedback"]
    wet1, wet2, dry = params["wet1"], params["wet2"], params["dry"]
    gain = params["gain"]
    t0 = state["t"]

    if mono:
        in2l = in2r = x
        in1l = in1r = (jnp.float32(2.0) * x + DC_OFFSET) * gain
    else:
        in2l, in2r = x[..., 0], x[..., 1]
        in1l = (in2l + DC_OFFSET) * gain
        in1r = (in2r + DC_OFFSET) * gain

    bufs = jnp.concatenate([state["combL_buf"], state["combR_buf"]])
    store0 = jnp.concatenate([state["storeL"], state["storeR"]])

    # v_base[i, s] = the comb tap ignoring in-window feedback: the carried
    # ring for s < D_i, the delayed input for s >= D_i
    in1l_p = jnp.pad(in1l, (0, np_len - n))
    in1r_p = jnp.pad(in1r, (0, np_len - n))
    v_base_rows = []
    for i in range(16):
        d = int(D[i])
        head = _ring_head(bufs[i], d, t0)
        inrow = in1l_p if i < 8 else in1r_p
        v_base_rows.append(jnp.concatenate([head, inrow[:np_len - d]]))
    v_base = jnp.stack(v_base_rows)                      # [16, np_len]
    # in-window feedback is active only once the tap falls inside the window
    mask = np.zeros((16, np_len), np.float32)
    for i in range(16):
        mask[i, int(D[i]):] = 1.0
    mask = jnp.asarray(mask)

    # the lag-1 filterstore recurrence per block as ONE matmul against
    # the damp1-power matrix (see _lowtri_powers_T); the block walk is a
    # lax.scan whose carry is a 2-block ALIGNED history, so every lag-D
    # read (D in [B, 2B)) is a STATIC per-row slice — the serial body
    # compiles to one matmul + one fused copy pass
    lt_T = _lowtri_powers_T(damp1, B)
    p_next = damp1 * lt_T[0]            # damp1^(j+1), j = 0..B-1
    fb_mask = feedback * mask           # [16, np_len]
    v_xs = v_base.reshape(16, K, B).transpose(1, 0, 2)
    fb_xs = fb_mask.reshape(16, K, B).transpose(1, 0, 2)

    # the damp1-power kernel decays geometrically, so for damp1 below
    # _FIR_DAMP_MAX the triangular solve truncates EXACTLY (in f32) to a
    # _FIR_W-tap FIR: damp1^128 <= 1e-19 at 0.71 — orders below both f32
    # resolution and the scan-reassociation noise the <=2e-6 gate already
    # absorbs.  Elementwise shift-FMAs replace a 16xBxB matmul per block
    # step; damp1 > _FIR_DAMP_MAX keeps the matmul.
    fir_w = min(_FIR_W, B)
    fir_coef = damp2 * jnp.concatenate(
        [jnp.ones((1,), jnp.float32),
         jnp.cumprod(jnp.full((fir_w - 1,), damp1, jnp.float32))])
    use_fir = damp1 <= jnp.float32(_FIR_DAMP_MAX)

    def st_fir(vd):
        vp = jnp.pad(vd, ((0, 0), (fir_w - 1, 0)))
        acc = fir_coef[0] * vd
        for k in range(1, fir_w):
            acc = acc + fir_coef[k] * vp[:, fir_w - 1 - k:
                                         fir_w - 1 - k + B]
        return acc

    def st_mat(vd):
        # HIGHEST: full f32, never TF32 — the fused output is gated at
        # <= 2e-6 against the f32 reference
        return jnp.dot(damp2 * vd, lt_T,
                       precision=_HIGHEST)

    def comb_block(hist, xs):
        v_bb, fb_bb = xs
        # hist holds store for the previous 2 blocks; row i's lag-D_i
        # window starts at the static offset 2B - D_i
        sh = jnp.stack([hist[i, 2 * B - int(D[i]): 3 * B - int(D[i])]
                        for i in range(16)])
        v_blk = v_bb + fb_bb * sh
        st_blk = (lax.cond(use_fir, st_fir, st_mat, v_blk)
                  + hist[:, -1][:, None] * p_next[None, :])
        hist = jnp.concatenate([hist[:, B:], st_blk], axis=1)
        return hist, (v_blk, st_blk)

    hist0 = jnp.zeros((16, 2 * B), jnp.float32).at[:, -1].set(store0)
    # unroll: the serial block walk's cost is per-step overhead, not
    # the 16xB matmul, so 4 fused bodies run per loop trip
    _, (v_blocks, st_blocks) = lax.scan(comb_block, hist0, (v_xs, fb_xs),
                                        unroll=4)
    v = jnp.transpose(v_blocks, (1, 0, 2)).reshape(16, np_len)
    store_full = jnp.transpose(st_blocks, (1, 0, 2)).reshape(16, np_len)
    outl = jnp.sum(v[:8], axis=0)[:n]
    outr = jnp.sum(v[8:], axis=0)[:n]

    # comb ring write-back: w[s] = in1[s] + feedback*store[s], last D_i kept
    new_bufs = bufs
    for i in range(16):
        d = int(D[i])
        inrow = in1l if i < 8 else in1r
        w_tail = (inrow[n - d:n]
                  + feedback * store_full[i, n - d:n])
        new_bufs = new_bufs.at[i].set(_ring_store(new_bufs[i], d, t0 + n,
                                                  w_tail))

    # series allpasses, each decimated over its own delay
    ap_out = []
    new_ap = []
    for side, (abuf, ds, sig) in enumerate((
            (state["apL_buf"], sizes["apL"], outl),
            (state["apR_buf"], sizes["apR"], outr))):
        x_s = sig
        nbuf = abuf
        for i in range(4):
            d = int(ds[i])
            head = _ring_head(abuf[i], d, t0)
            k2 = -(-n // d)
            xp = jnp.pad(x_s, (0, k2 * d - n)).reshape(k2, d)
            w = _scan1(xp, jnp.float32(0.5), head, axis=0)
            wf = w.reshape(k2 * d)
            vtap = jnp.concatenate([head, wf])[:n]
            nbuf = nbuf.at[i].set(_ring_store(nbuf[i], d, t0 + n,
                                              wf[n - d:n]))
            x_s = vtap - x_s
        ap_out.append(x_s)
        new_ap.append(nbuf)
    outl = ap_out[0] - DC_OFFSET
    outr = ap_out[1] - DC_OFFSET

    yl = outl * wet1 + outr * wet2 + in2l * dry
    yr = outr * wet1 + outl * wet2 + in2r * dry
    new_state = {"combL_buf": new_bufs[:8], "combR_buf": new_bufs[8:],
                 "apL_buf": new_ap[0], "apR_buf": new_ap[1],
                 "storeL": store_full[:8, n - 1],
                 "storeR": store_full[8:, n - 1],
                 "t": t0 + n}
    return new_state, jnp.stack([yl, yr], axis=-1)


def _freeverb_process_scan(state, x: jnp.ndarray, params, rate: int,
                           mono: bool):
    """Per-sample scan fallback (exact C op order) for low rates."""
    sizes = freeverb_sizes(rate)
    cL = jnp.asarray(sizes["combL"])
    cR = jnp.asarray(sizes["combR"])
    aL = jnp.asarray(sizes["apL"])
    aR = jnp.asarray(sizes["apR"])
    damp1 = params["damp1"]
    damp2 = params["damp2"]
    feedback = params["feedback"]
    wet1, wet2, dry = params["wet1"], params["wet2"], params["dry"]
    gain = params["gain"]

    def step(carry, xin):
        st = carry
        t = st["t"]
        if mono:
            in2l = in2r = xin
            in1l = in1r = (jnp.float32(2.0) * xin + DC_OFFSET) * gain
        else:
            in2l, in2r = xin[0], xin[1]
            in1l = (in2l + DC_OFFSET) * gain
            in1r = (in2r + DC_OFFSET) * gain
        idx_cl = jnp.remainder(t, cL)
        idx_cr = jnp.remainder(t, cR)
        bufL, storeL, tmpL = _comb_bank(st["combL_buf"], st["storeL"],
                                        idx_cl, in1l, damp1, damp2, feedback)
        bufR, storeR, tmpR = _comb_bank(st["combR_buf"], st["storeR"],
                                        idx_cr, in1r, damp1, damp2, feedback)
        out_l = jnp.sum(tmpL)
        out_r = jnp.sum(tmpR)
        idx_al = jnp.remainder(t, aL)
        idx_ar = jnp.remainder(t, aR)
        apL, out_l = _allpass_chain(st["apL_buf"], idx_al, out_l)
        apR, out_r = _allpass_chain(st["apR_buf"], idx_ar, out_r)
        out_l = out_l - DC_OFFSET
        out_r = out_r - DC_OFFSET
        yl = out_l * wet1 + out_r * wet2 + in2l * dry
        yr = out_r * wet1 + out_l * wet2 + in2r * dry
        new = {"combL_buf": bufL, "combR_buf": bufR,
               "apL_buf": apL, "apR_buf": apR,
               "storeL": storeL, "storeR": storeR, "t": t + 1}
        return new, jnp.stack([yl, yr])

    state, y = lax.scan(step, state, x)
    return state, y


# ---------------------------------------------------------------------------
# removesilence VAD
# ---------------------------------------------------------------------------

VAD_POWER_ALPHA = 0x0800
VAD_RING = 256
_VAD_UNROLL = 128
_VAD_B = 0xFFFF - VAD_POWER_ALPHA


def _vad_power_step32(hi, lo, s):
    """One truncating power update on 16-bit limbs (hi, lo) of the
    power accumulator — all intermediates fit i32.

    Derivation: with p = hi<<16 | lo, the reference update
    p' = A*s + B*(p>>16) + ((B*(p&0xFFFF))>>16)  [vad_private.c:117]
    equals t1 + B*hi with t1 = A*s + ((B*lo)>>16);
    (B*lo)>>16 == (B*(lo>>8) + ((B*(lo&0xFF))>>8)) >> 8 exactly
    (floor-of-floor identities), and B*hi splits as
    (n1<<16) + (n0<<8) + m0 with m1 = B*(hi>>8), n1 = m1>>8,
    n0 = m1&0xFF, m0 = B*(hi&0xFF).  The steady state keeps
    p < 0xFFFF0000, so hi' fits 16 bits."""
    A = jnp.int32(VAD_POWER_ALPHA)
    B = jnp.int32(_VAD_B)
    e8 = jnp.int32(8)
    blo16 = (B * (lo >> e8)
             + ((B * (lo & jnp.int32(0xFF))) >> e8)) >> e8
    t1 = A * s + blo16
    m1 = B * (hi >> e8)
    m0 = B * (hi & jnp.int32(0xFF))
    n1 = m1 >> e8
    n0 = m1 & jnp.int32(0xFF)
    s1 = t1 + m0 + (n0 << e8)
    return (s1 >> jnp.int32(16)) + n1, s1 & jnp.int32(0xFFFF)


def _vad_powers_serial(p0_hi_lo, sq):
    """Block-end (hi, lo) power limbs for every block by the exact serial
    recurrence: sq [nb, n] i32 -> [nb, 2] i32, carried across blocks from
    the initial limbs p0_hi_lo [2]."""
    nb, n = sq.shape

    def block(k, carry):
        hl, ends = carry
        row = sq[k]
        hl = lax.fori_loop(
            0, n, lambda j, hl: _vad_power_step32(hl[0], hl[1], row[j]),
            hl, unroll=_VAD_UNROLL)
        return hl, ends.at[k].set(jnp.stack(hl))

    init = ((p0_hi_lo[0], p0_hi_lo[1]), jnp.zeros((nb, 2), jnp.int32))
    return lax.fori_loop(0, nb, block, init)[1]


def _vad_powers_bracket(sq64: jnp.ndarray):
    """Per-block power endpoints WITHOUT the cross-block serial chain.

    The reference update (vad_private.c:117) is exactly
    p' = A*s + floor(B*p / 2^16)  [B*p = (B*(p>>16))<<16 + B*(p&0xFFFF),
    so the two-halves formula IS the single floor], which is MONOTONE
    in p and a contraction (slope B/2^16 = 1 - 2^-5).  Running each
    block's recurrence from the two extreme initial powers 0 and
    2^32-1 brackets EVERY possible incoming power; equal endpoints
    prove the block's output is independent of its true (chained)
    initial value.  All blocks then run in PARALLEL (rows elementwise,
    samples scanned) instead of as one serial scalar
    chain over nb*n samples.  Returns (lo_end, hi_end) [nb] i64."""
    A = jnp.int64(VAD_POWER_ALPHA)
    B = jnp.int64(_VAD_B)
    nb = sq64.shape[0]
    p0 = jnp.stack([jnp.zeros(nb, jnp.int64),
                    jnp.full(nb, 0xFFFFFFFF, jnp.int64)])

    def step(p, s):
        return A * s[None, :] + ((B * p) >> 16), None

    pend, _ = lax.scan(step, p0, sq64.T, unroll=32)
    return pend[0], pend[1]


def vad_window(state, data: jnp.ndarray, threshold: jnp.ndarray,
               hysteresis: jnp.ndarray):
    """Whole-window VAD: all blocks of data [nb, n] at once, exactly
    equal to folding vad_block over the rows.  The serial truncating
    power recurrence is bracketed per block (_vad_powers_bracket) so
    blocks run in parallel; when any block's bracket fails to coalesce
    (possible only for pathological near-constant power trajectories —
    the contraction closes a width-2^32 bracket in ~1k samples), the
    window falls back to the exact serial recurrence.  Bit-exact
    either way.  The ZCR windows (wholly inside each block once
    n >= VAD_RING) and the hysteresis machine vectorize outside.
    Returns (state', frame_types [nb])."""
    nb, n = data.shape
    if n < VAD_RING:
        raise ValueError("vad_window needs n >= VAD_RING")
    d64 = data.astype(jnp.int64)
    sq64 = ((d64 * d64) >> 14) & 0xFFFF
    sq = sq64.astype(jnp.int32)
    p0 = jnp.stack([(state["power"] >> 16).astype(jnp.int32),
                    (state["power"] & 0xFFFF).astype(jnp.int32)])
    lo_end, hi_end = _vad_powers_bracket(sq64)

    def _serial(_):
        hl = _vad_powers_serial(p0, sq)
        return ((hl[:, 0].astype(jnp.int64) << 16)
                | hl[:, 1].astype(jnp.int64))

    powers = lax.cond(jnp.all(lo_end == hi_end),
                      lambda _: lo_end, _serial, None)
    # ZCR: entries = RING-1 once count > RING, so each block's window
    # is its own trailing 255 samples (254 adjacent pairs)
    seg = data[:, n - (VAD_RING - 1):]
    neg = seg < 0
    zcr = jnp.sum(jnp.where(neg[:, :-1] != neg[:, 1:], 1, -1), axis=1)
    raw = jnp.where((powers > threshold) & (zcr < 0), 1, 0
                    ).astype(jnp.int32)

    def hyst(carry, ft):
        vstate, samples = carry
        changed = vstate != ft
        v2s = changed & (vstate == 1)
        samples_v2s = samples + n
        leave = samples_v2s >= hysteresis
        new_state = jnp.where(
            changed,
            jnp.where(v2s, jnp.where(leave, ft, vstate), ft), vstate)
        new_samples = jnp.where(changed & v2s & ~leave, samples_v2s,
                                jnp.int64(0))
        return (new_state, new_samples), new_state

    (vstate, samples), frame_types = lax.scan(
        hyst, (state["state"], state["samples"]), raw,
        unroll=8 if nb % 8 == 0 else 1)
    flat_tail = data.reshape(-1)[nb * n - VAD_RING:]
    idx = ((state["count"] + nb * n - VAD_RING
            + jnp.arange(VAD_RING, dtype=jnp.int64)) & (VAD_RING - 1)
           ).astype(jnp.int32)
    new = {"ring": state["ring"].at[idx].set(flat_tail),
           "count": state["count"] + nb * n,
           "power": powers[-1],
           "state": vstate,
           "samples": samples}
    return new, frame_types


def vad_init_state():
    return {"ring": jnp.zeros(VAD_RING, jnp.int16),
            "count": jnp.int64(0),
            "power": jnp.int64(0),
            "state": jnp.int32(0),       # 0 silence, 1 voice
            "samples": jnp.int64(0)}


def vad_block(state, data: jnp.ndarray, threshold: jnp.ndarray,
              hysteresis: jnp.ndarray):
    """One vad_update call (vad_private.c:117-160) over a block of S16
    samples.  Returns (state, frame_type int32)."""
    n = data.shape[0]

    # power: p' = A*sq + B*(p>>16) + ((B*(p&0xFFFF))>>16) — a scalar
    # affine recurrence.  The squares vectorize; the chain unrolls
    # _VAD_UNROLL steps per scan iteration so the loop is ~32x shorter
    # than a per-sample scan (and carries no ring: a dynamic scatter per
    # sample dominated an earlier form).
    sq_all = ((data.astype(jnp.int64) * data.astype(jnp.int64))
              >> 14) & 0xFFFF
    B = 0xFFFF - VAD_POWER_ALPHA

    def apply(p, s):
        return (VAD_POWER_ALPHA * s + B * (p >> 16)
                + (B * (p & 0xFFFF) >> 16))

    power = state["power"]
    main = (n // _VAD_UNROLL) * _VAD_UNROLL
    if main:
        def step(p, chunk):
            for j in range(_VAD_UNROLL):
                p = apply(p, chunk[j])
            return p, None

        power, _ = lax.scan(
            step, power, sq_all[:main].reshape(-1, _VAD_UNROLL))
    for j in range(main, n):                  # static tail
        power = apply(power, sq_all[j])

    # ring: after the block it holds the LAST min(n, RING) samples at
    # their ((count + i) & mask) slots — one vectorized scatter
    # replaces n sequential ones
    mask = VAD_RING - 1
    if n >= VAD_RING:
        base = n - VAD_RING
        idx = ((state["count"] + base
                + jnp.arange(VAD_RING, dtype=jnp.int64)) & mask
               ).astype(jnp.int32)
        ring = state["ring"].at[idx].set(data[base:])
    else:
        idx = ((state["count"]
                + jnp.arange(n, dtype=jnp.int64)) & mask
               ).astype(jnp.int32)
        ring = state["ring"].at[idx].set(data)
    count = state["count"] + n

    # ZCR over the ring contents in queue order
    entries = jnp.minimum(count, VAD_RING - 1).astype(jnp.int32)
    head = (count & (VAD_RING - 1)).astype(jnp.int32)
    tail = (head - entries) & (VAD_RING - 1)
    idx = (tail + jnp.arange(VAD_RING, dtype=jnp.int32)) & (VAD_RING - 1)
    vals = ring[idx]
    neg = vals < 0
    pair_valid = jnp.arange(VAD_RING) < (entries - 1)
    contrib = jnp.where(neg[:-1] != neg[1:], 1, -1)
    zcr = jnp.sum(jnp.where(pair_valid[:-1], contrib, 0))

    frame_type = jnp.where((power > threshold) & (zcr < 0), 1, 0
                           ).astype(jnp.int32)

    # hysteresis state machine
    old_state = state["state"]
    samples = state["samples"]
    changed = old_state != frame_type
    v2s = changed & (old_state == 1)
    samples_v2s = samples + n
    leave = samples_v2s >= hysteresis
    new_state = jnp.where(
        changed, jnp.where(v2s, jnp.where(leave, frame_type, old_state),
                           frame_type), old_state)
    new_samples = jnp.where(
        changed & v2s & ~leave, samples_v2s, jnp.int64(0))

    new = {"ring": ring, "count": count, "power": power,
           "state": new_state, "samples": new_samples}
    return new, new_state


# ---------------------------------------------------------------------------
# bs2b crossfeed (ext/bs2b/gstbs2b.c wrapping the public-domain libbs2b)
# ---------------------------------------------------------------------------


def first_order_iir(d: jnp.ndarray, c, y0: jnp.ndarray) -> jnp.ndarray:
    """Parallel first-order recurrence y[n] = c*y[n-1] + d[n], y[-1] = y0.

    Solved in O(log N) depth with an associative scan over the affine maps
    y -> c*y + d (compose: (a1,b1)∘(a2,b2) = (a1*a2, b2 + a2*b1)) — the
    parallel form of the sample-serial IIR loops the reference delegates
    to external DSP libraries.  d: [N, ...]; y0 broadcastable to d[0]."""
    cs = jnp.broadcast_to(jnp.asarray(c, d.dtype), d.shape)

    def compose(l, r):
        a1, b1 = l
        a2, b2 = r
        return a1 * a2, b2 + a2 * b1

    a, b = lax.associative_scan(compose, (cs, d), axis=0)
    return b + a * y0


def bs2b_cross_feed(state, x: jnp.ndarray, coef):
    """libbs2b cross_feed_d on a block: x [N, 2] float64.

    Per sample (libbs2b bs2b.c cross_feed_d; element hook
    ext/bs2b/gstbs2b.c:341-361):
      lo[ch]   = a0_lo*x[ch] + b1_lo*lo[ch]            (lowpass)
      hi[ch]   = a0_hi*x[ch] + a1_hi*asis[ch] + b1_hi*hi[ch]  (high boost)
      asis[ch] = x[ch]
      out      = (hi + swap(lo)) * gain                (crossfeed)
    state = {"lo": [2], "hi": [2], "asis": [2]} float64 carries."""
    lo = first_order_iir(coef["a0_lo"] * x, coef["b1_lo"], state["lo"])
    x_prev = jnp.concatenate([state["asis"][None, :], x[:-1]], axis=0)
    hi = first_order_iir(coef["a0_hi"] * x + coef["a1_hi"] * x_prev,
                         coef["b1_hi"], state["hi"])
    out = (hi + lo[:, ::-1]) * coef["gain"]
    new_state = {"lo": lo[-1], "hi": hi[-1], "asis": x[-1]}
    return new_state, out


def bs2b_coefficients(fcut: float, feed: float, rate: int):
    """libbs2b init(): filter design from (fcut Hz, feed dB*10, srate).

    feed is split between attenuating the crossfed lowpass (GB_lo) and
    boosting the direct high band (GB_hi); gain renormalizes the sum.
    Host-side float64 (numpy), recomputed when fcut/feed change — the
    bs2b_set_level_fcut/feed analog (gstbs2b.c:370-381)."""
    level = float(feed) / 10.0
    gb_lo = level * -5.0 / 6.0 - 3.0
    gb_hi = level / 6.0 - 3.0
    g_lo = 10.0 ** (gb_lo / 20.0)
    g_hi = 1.0 - 10.0 ** (gb_hi / 20.0)
    fc_lo = float(fcut)
    fc_hi = fc_lo * 2.0 ** ((gb_lo - 20.0 * np.log10(g_hi)) / 12.0)
    x = np.exp(-2.0 * np.pi * fc_lo / rate)
    b1_lo, a0_lo = x, g_lo * (1.0 - x)
    x = np.exp(-2.0 * np.pi * fc_hi / rate)
    b1_hi, a0_hi, a1_hi = x, 1.0 - g_hi * (1.0 - x), -x
    gain = 1.0 / (1.0 - g_hi + g_lo)
    return {"b1_lo": jnp.float64(b1_lo), "a0_lo": jnp.float64(a0_lo),
            "b1_hi": jnp.float64(b1_hi), "a0_hi": jnp.float64(a0_hi),
            "a1_hi": jnp.float64(a1_hi), "gain": jnp.float64(gain)}


# ---------------------------------------------------------------------------
# webrtcdsp kernels (ext/webrtcdsp analog): biquad, STFT noise suppression
# ---------------------------------------------------------------------------


def biquad(x: jnp.ndarray, b, a, state):
    """Direct-form-II-transposed biquad over axis 0, parallel via
    associative scan on 2x2 affine maps.

    y[n] = b0 x[n] + s1[n-1];  s1[n] = b1 x[n] - a1 y[n] + s2[n-1];
    s2[n] = b2 x[n] - a2 y[n].
    x: [N, C]; b = (b0,b1,b2), a = (1,a1,a2); state: [2, C] (s1, s2).
    Returns (y, new_state)."""
    b0, b1, b2 = b
    _, a1, a2 = a
    # State-space: s[n] = A s[n-1] + B x[n];  y[n] = b0 x[n] + s1[n-1]
    #   s1[n] = -a1 s1[n-1] + s2[n-1] + (b1 - a1 b0) x[n]
    #   s2[n] = -a2 s1[n-1]           + (b2 - a2 b0) x[n]
    A = jnp.array([[-a1, 1.0], [-a2, 0.0]], x.dtype)
    Bv = jnp.array([b1 - a1 * b0, b2 - a2 * b0], x.dtype)
    d = x[:, None, :] * Bv[None, :, None]          # [N, 2, C]
    n = x.shape[0]
    As = jnp.broadcast_to(A, (n, 2, 2))

    def compose(l, r):
        m1, v1 = l
        m2, v2 = r
        return (jnp.matmul(m2, m1, precision=_HIGHEST),
                jnp.einsum("nij,njc->nic", m2, v1, precision=_HIGHEST) + v2)

    Ms, vs = lax.associative_scan(compose, (As, d), axis=0)
    s = (jnp.einsum("nij,jc->nic", Ms, state, precision=_HIGHEST)
         + vs)   # s[n] for every n
    s_prev = jnp.concatenate([state[None], s[:-1]], axis=0)
    y = b0 * x + s_prev[:, 0, :]
    return y, s[-1]


def butter_highpass(fc: float, rate: int):
    """2nd-order Butterworth highpass (bilinear transform) — the
    webrtcdsp high-pass-filter analog (WebRTC APM uses a fixed ~90 Hz
    rumble filter)."""
    w = np.tan(np.pi * fc / rate)
    k = 1.0 / (1.0 + np.sqrt(2.0) * w + w * w)
    b = (k, -2.0 * k, k)
    a = (1.0, 2.0 * k * (w * w - 1.0), k * (1.0 - np.sqrt(2.0) * w + w * w))
    return b, a


def stft_frames(x: jnp.ndarray, tail: jnp.ndarray, frame: int):
    """[N, C] signal + [hop, C] carried tail -> Hann-analysis frames
    [F, frame, C] with 50% overlap (hop = frame//2); F = N // hop.
    Hann at 50% overlap OLAs back to unity with a rectangular synthesis
    window, so istft is a plain overlap-add."""
    hop = frame // 2
    n, c = x.shape
    buf = jnp.concatenate([tail, x], axis=0)       # [N + hop, C]
    f = n // hop
    idx = jnp.arange(f)[:, None] * hop + jnp.arange(frame)[None, :]
    frames = buf[idx]                              # [F, frame, C]
    win = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi
                              * jnp.arange(frame, dtype=x.dtype) / frame)
    return frames * win[None, :, None], buf[n:]


def ola(frames: jnp.ndarray, acc: jnp.ndarray):
    """Overlap-add [F, frame, C] -> ([F*hop, C], new acc [hop, C])."""
    f, frame, c = frames.shape
    hop = frame // 2
    first = frames[:, :hop, :].reshape(f * hop, c)
    second = frames[:, hop:, :].reshape(f * hop, c)
    out = first + jnp.concatenate([acc, second[:-hop]], axis=0)
    return out, second[-hop:]


# WebRTC noise-suppression constants (the published float implementation,
# webrtc-audio-processing ns_core.c; the reference element drives exactly
# that module — gstwebrtcdsp.cpp noise-suppression-level): staggered
# 3-window log-quantile noise estimation, LRT/flatness/difference speech
# probability, decision-directed Wiener gain.  Parameter values follow the
# published code; without the library in this environment the output is
# structurally (not bit-) validated — tests/test_audio.py oracles SNR
# improvement and attenuation caps.
NS_SIMULT = 3
NS_END_STARTUP = 200          # END_STARTUP_LONG (frames)
NS_FACTOR = 40.0
NS_WIDTH = 0.01
NS_QUANTILE = 0.25
NS_LRT_TAVG = 0.50            # LRT time-averaging
NS_DD = 0.98                  # decision-directed prior-SNR weight
NS_PRIOR_UPDATE = 0.10        # prior speech-probability update rate
NS_GAMMA_NOISE = 0.90         # speech-gated noise update
NS_WIDTH_PRIOR = 4.0          # tanh indicator width
NS_THRESH_LRT = 0.5
NS_THRESH_FLAT = 0.30
NS_THRESH_DIFF = 0.25
NS_WEIGHTS = (1.0, 0.0, 0.0)  # LRT / flatness / difference (model default)


def ns_init(bins: int, channels: int):
    """Carried state for noise_suppress (per [bins, C] spectrum)."""
    f32 = jnp.float32
    return {
        # staggered log-quantile estimator (one window per SIMULT slot)
        "lquantile": jnp.full((NS_SIMULT, bins, channels), 8.0, f32),
        "density": jnp.full((NS_SIMULT, bins, channels), 0.3, f32),
        "counter": (jnp.arange(NS_SIMULT, dtype=jnp.int32)
                    * (NS_END_STARTUP // NS_SIMULT)),
        "quantile": jnp.zeros((bins, channels), f32),   # current noise est
        "updates": jnp.int32(0),
        # decision-directed Wiener + speech model
        "prev_magn": jnp.ones((bins, channels), f32),
        "prev_gain": jnp.ones((bins, channels), f32),
        "log_lrt_tavg": jnp.zeros((bins, channels), f32),
        "prior_speech": jnp.full((channels,), 0.5, f32),
        "magn_avg_pause": jnp.zeros((bins, channels), f32),
    }


def noise_suppress(frames: jnp.ndarray, ns_state, g_min: jnp.ndarray):
    """WebRTC-structure noise suppression over Hann frames.

    Per 10 ms frame (sequential model tracking, scanned; all-bins math
    vectorized over [bins, C]):
      1. magnitude spectrum;
      2. staggered log-quantile noise estimation (3 windows of
         END_STARTUP frames; the longest-running window is the estimate,
         windows promote to `quantile` as they wrap);
      3. speech probability: time-averaged per-bin log likelihood ratio
         + spectral flatness + spectral template difference, combined
         through tanh indicators into a prior, per-bin posterior
         1/(1 + (1-q)/q * exp(-logLRT));
      4. speech-gated noise update
         noise <- g*noise + (1-g)*(P(noise)*magn + P(speech)*noise);
      5. decision-directed Wiener gain prior/(1+prior) clipped to
         [g_min, 1] — g_min = 10^(-max_atten_dB/20) from the
         suppression level (low/moderate/high/very-high -> 6/10/15/25 dB,
         the NS mode attenuation caps).
    frames: [F, frame, C] f32; ns_state: ns_init() pytree."""
    w_lrt, w_flat, w_diff = NS_WEIGHTS

    def step(st, fr):
        spec = jnp.fft.rfft(fr, axis=0)
        magn = jnp.abs(spec).astype(jnp.float32)
        lmagn = jnp.log(jnp.maximum(magn, 1e-10))

        # -- quantile noise estimation (staggered windows) ---------------
        counter = st["counter"] + 1                       # [SIMULT]
        cnt = counter.astype(jnp.float32)[:, None, None]
        delta = jnp.where(st["density"] > 1.0,
                          NS_FACTOR / st["density"], NS_FACTOR)
        above = lmagn[None] > st["lquantile"]
        lq = st["lquantile"] + jnp.where(
            above, NS_QUANTILE * delta / cnt,
            -(1.0 - NS_QUANTILE) * delta / cnt)
        dens = jnp.where(
            jnp.abs(lmagn[None] - lq) < NS_WIDTH,
            ((cnt - 1.0) * st["density"] + 1.0 / (2.0 * NS_WIDTH)) / cnt,
            st["density"])
        # windows that wrap promote their quantile and restart; the
        # promoted window refreshes the running estimate so the quantile
        # tracker stays live after startup (floor changes are caught
        # every END_STARTUP/SIMULT frames)
        wrap = counter >= NS_END_STARTUP                  # [SIMULT]
        wrap_any = jnp.any(wrap)
        live_q = jnp.exp(lq[jnp.argmax(counter)])         # longest window
        startup = st["updates"] < NS_END_STARTUP
        carried = st["quantile"]
        noise_prev = jnp.where(
            startup, live_q,
            jnp.where(wrap_any, 0.5 * (carried + live_q), carried))
        noise_prev = jnp.maximum(noise_prev, 1e-10)
        counter = jnp.where(wrap, 0, counter)
        lq = jnp.where(wrap[:, None, None],
                       jnp.broadcast_to(lmagn[None], lq.shape), lq)
        dens = jnp.where(wrap[:, None, None], 0.3, dens)

        # -- speech probability ------------------------------------------
        snr_post = jnp.maximum(
            jnp.square(magn) / jnp.square(noise_prev) - 1.0, 0.0)
        prev_est = (jnp.square(st["prev_gain"])
                    * jnp.square(st["prev_magn"])
                    / jnp.square(noise_prev))
        snr_prior = NS_DD * prev_est + (1.0 - NS_DD) * snr_post
        # per-bin LRT, time-averaged
        lrt = (snr_post * snr_prior / (1.0 + snr_prior)
               - jnp.log1p(snr_prior))
        log_lrt = (st["log_lrt_tavg"]
                   + NS_LRT_TAVG * (lrt - st["log_lrt_tavg"]))
        feat_lrt = jnp.mean(log_lrt, axis=0)              # [C]
        # spectral flatness: exp(mean log)/mean
        flat = (jnp.exp(jnp.mean(lmagn, axis=0))
                / jnp.maximum(jnp.mean(magn, axis=0), 1e-10))
        # spectral template difference vs the pause average
        pause = st["magn_avg_pause"]
        avg_m = jnp.mean(magn, axis=0, keepdims=True)
        avg_p = jnp.mean(pause, axis=0, keepdims=True)
        num = jnp.sum((magn - avg_m) * (pause - avg_p), axis=0)
        den = jnp.maximum(jnp.sum(jnp.square(pause - avg_p), axis=0),
                          1e-10)
        resid = (magn - avg_m) - (pause - avg_p) * (num / den)[None]
        diff = (jnp.sum(jnp.square(resid), axis=0)
                / jnp.maximum(jnp.sum(jnp.square(avg_m)) * magn.shape[0],
                              1e-10))
        ind0 = 0.5 * (jnp.tanh(NS_WIDTH_PRIOR
                               * (feat_lrt - NS_THRESH_LRT)) + 1.0)
        ind1 = 0.5 * (jnp.tanh(2.0 * NS_WIDTH_PRIOR
                               * (NS_THRESH_FLAT - flat)) + 1.0)
        ind2 = 0.5 * (jnp.tanh(NS_WIDTH_PRIOR
                               * (diff - NS_THRESH_DIFF)) + 1.0)
        ind = w_lrt * ind0 + w_flat * ind1 + w_diff * ind2
        prior = (st["prior_speech"]
                 + NS_PRIOR_UPDATE * (ind - st["prior_speech"]))
        gain_prior = (1.0 - prior) / (prior + 1e-4)       # [C]
        p_speech = 1.0 / (1.0 + gain_prior[None]
                          * jnp.exp(-log_lrt))            # [bins, C]

        # pause template follows low-speech frames
        pause = jnp.where((prior < 0.5)[None],
                          pause + 0.1 * (magn - pause), pause)

        # -- speech-gated noise update -----------------------------------
        noise = (NS_GAMMA_NOISE * noise_prev
                 + (1.0 - NS_GAMMA_NOISE)
                 * ((1.0 - p_speech) * magn + p_speech * noise_prev))

        # -- decision-directed Wiener gain -------------------------------
        gain = jnp.clip(snr_prior / (1.0 + snr_prior), g_min, 1.0)
        out = jnp.fft.irfft(spec * gain, n=fr.shape[0], axis=0)

        st2 = {"lquantile": lq.astype(jnp.float32),
               "density": dens.astype(jnp.float32),
               "counter": counter,
               "quantile": noise.astype(jnp.float32),
               "updates": jnp.minimum(st["updates"] + 1,
                                      jnp.int32(2 ** 30)),
               "prev_magn": magn,
               "prev_gain": gain.astype(jnp.float32),
               "log_lrt_tavg": log_lrt.astype(jnp.float32),
               "prior_speech": prior.astype(jnp.float32),
               "magn_avg_pause": pause.astype(jnp.float32)}
        return st2, out.astype(jnp.float32)

    ns_state, out = lax.scan(step, ns_state, frames)
    return out, ns_state


def agc_adaptive(frames_rms_db: jnp.ndarray, gain_db0: jnp.ndarray,
                 target_dbfs, max_gain_db, rate_db=0.5):
    """Adaptive-digital gain control: per-10ms-frame gain walks toward
    (target - level) bounded by [0, compression-gain-db], rate-limited to
    rate_db per frame (the webrtc AGC's slow digital adaptation analog).
    frames_rms_db: [F] dBFS of the frame *after* current gain would not
    be known — adaptation uses the raw level, the standard feedforward
    form.  Sequential, but F is small: scanned."""
    def step(g, lvl):
        desired = jnp.clip(-target_dbfs - lvl, 0.0, max_gain_db)
        g2 = g + jnp.clip(desired - g, -rate_db, rate_db)
        # hold gain during near-silence (no signal to act on)
        g2 = jnp.where(lvl < -70.0, g, g2)
        return g2, g2

    return lax.scan(step, gain_db0, frames_rms_db)


# ---------------------------------------------------------------------------
# Adaptive echo cancellation: partitioned-block frequency-domain NLMS
# (PBFDAF) + coherence NLP — the published structure of the WebRTC AEC
# (webrtc-audio-processing aec_core.c: partitioned frequency-domain
# adaptive filter, gradient constraint, smoothed-coherence nonlinear
# processor with per-level overdrive), which is exactly the module the
# reference drives (gstwebrtcdsp.cpp:1000-1015 echo-cancel /
# echo-suppression-level, :1048-1054 extended-filter).  Library
# fixed-point internals and the exact hNl curve shaping are the
# documented divergence; convergence and double-talk behaviour are
# oracled in tests/test_audio.py.
# ---------------------------------------------------------------------------

AEC_MU = 0.5         # NLMS step size (aec_core.c uses 0.5 normalized)
AEC_LAMBDA = 0.92    # PSD smoothing for the NLP coherences


def aec_init(frame: int, channels: int, partitions: int):
    """Carried state for aec_cancel: P-partition frequency-domain filter
    over 10 ms blocks (FFT size 2*frame, overlap-save), far-spectrum
    FIFO, previous time blocks, and the NLP's smoothed (cross-)spectra."""
    bins2 = frame + 1
    f32, c64 = jnp.float32, jnp.complex64
    return {
        "W": jnp.zeros((partitions, bins2, channels), c64),
        "Xf": jnp.zeros((partitions, bins2, channels), c64),
        "far_prev": jnp.zeros((frame, channels), f32),
        "d_prev": jnp.zeros((frame, channels), f32),
        "e_prev": jnp.zeros((frame, channels), f32),
        "sd": jnp.full((bins2, channels), 1e2, f32),
        "se": jnp.full((bins2, channels), 1e2, f32),
        "sx": jnp.full((bins2, channels), 1e2, f32),
        "sde": jnp.zeros((bins2, channels), c64),
        "sxd": jnp.zeros((bins2, channels), c64),
    }


def aec_cancel(near: jnp.ndarray, far: jnp.ndarray, st, overdrive,
               mu: float = AEC_MU):
    """Cancel `far`'s echo from `near` ([N, C] f32, N a multiple of the
    10 ms block).  Returns (out [N, C], new_state).

    Per block (lax.scan — the filter adaptation is inherently
    sequential; all per-block math vectorizes over partitions, bins and
    channels, and the FFTs are batched XLA ops):
      1. far block FFT (overlap-save input [prev, cur]) pushed into the
         P-deep spectrum FIFO;
      2. echo estimate = sum_p W_p * X_{k-p}, IFFT, last `frame` samples
         (the causal overlap-save half); e = d - yhat;
      3. NLMS update W_p += mu * conj(X_p) * E / sum_p |X_p|^2 with the
         gradient constraint (acausal half of each partition's impulse
         response zeroed — the standard PBFDAF projection); adaptation
         is gated on far-end activity (the published AEC's echo-state
         logic: never adapt against a silent reference, where the
         normalized step would amplify near-end speech into the filter);
      4. NLP: coherence(d,e) and coherence(x,d) over lambda-smoothed
         overlap-save spectra; hNl = min(cohde, 1 - cohxd), gain =
         hNl^overdrive applied to E in overlap-save form.  The far
         (cross-)spectra forget fast (x0.5/block) while the far end is
         silent so a stopped reference releases the suppressor within a
         few blocks.  overdrive=0 bypasses the NLP (pure linear stage).
    """
    n, c = near.shape
    frame = st["far_prev"].shape[0]
    nb = n // frame
    nfft = 2 * frame
    d_blocks = near.reshape(nb, frame, c).astype(jnp.float32)
    x_blocks = far.reshape(nb, frame, c).astype(jnp.float32)
    lam = jnp.float32(AEC_LAMBDA)
    mu = jnp.float32(mu)
    od = jnp.float32(overdrive)
    zpad = jnp.zeros((frame, c), jnp.float32)

    def step(carry, inp):
        W, Xf, far_prev, d_prev, e_prev, sd, se, sx, sde, sxd = carry
        d, x = inp
        X = jnp.fft.rfft(jnp.concatenate([far_prev, x], axis=0),
                         axis=0).astype(jnp.complex64)
        Xf = jnp.roll(Xf, 1, axis=0).at[0].set(X)
        yh = jnp.fft.irfft(jnp.sum(W * Xf, axis=0), n=nfft,
                           axis=0)[frame:].astype(jnp.float32)
        e = d - yh
        E = jnp.fft.rfft(jnp.concatenate([zpad, e], axis=0),
                         axis=0).astype(jnp.complex64)
        # far-end activity per channel (int16 scale: silence ~ 0)
        far_act = jnp.mean(jnp.square(x), axis=0) > jnp.float32(1.0)  # [C]
        spow = jnp.sum(jnp.square(jnp.abs(Xf)), axis=0)      # [bins2, C]
        denom = spow + jnp.float32(1e-3) * jnp.mean(spow) + jnp.float32(1e-6)
        G = (mu * E / denom).astype(jnp.complex64)
        Wn = W + jnp.conj(Xf) * G[None]
        # gradient constraint: each partition's impulse response is a
        # causal `frame`-tap filter; zero the tail and re-transform
        wt = jnp.fft.irfft(Wn, n=nfft, axis=1)
        Wn = jnp.fft.rfft(wt.at[:, frame:, :].set(0.0),
                          axis=1).astype(jnp.complex64)
        Wn = jnp.where(far_act[None, None], Wn, W)
        # NLP coherences over the same overlap-save spectra
        D = jnp.fft.rfft(jnp.concatenate([d_prev, d], axis=0),
                         axis=0).astype(jnp.complex64)
        Ew = jnp.fft.rfft(jnp.concatenate([e_prev, e], axis=0),
                          axis=0).astype(jnp.complex64)
        lam_x = jnp.where(far_act, lam, jnp.float32(0.5))[None]  # [1, C]
        sd = lam * sd + (1.0 - lam) * jnp.square(jnp.abs(D))
        se = lam * se + (1.0 - lam) * jnp.square(jnp.abs(Ew))
        sx = lam_x * sx + (1.0 - lam_x) * jnp.square(jnp.abs(X))
        sde = (lam * sde + (1.0 - lam)
               * (jnp.conj(D) * Ew)).astype(jnp.complex64)
        sxd = (lam_x * sxd + (1.0 - lam_x)
               * (jnp.conj(X) * D)).astype(jnp.complex64)
        cohde = jnp.square(jnp.abs(sde)) / (sd * se + jnp.float32(1e-10))
        cohxd = jnp.square(jnp.abs(sxd)) / (sx * sd + jnp.float32(1e-10))
        hnl = jnp.clip(jnp.minimum(cohde, 1.0 - cohxd), 0.0, 1.0)
        # a fully-drained far FIFO means no echo is representable at all
        # (yhat is identically 0): bypass the suppressor, any residual
        # gain < 1 would be pure near-end damage
        fifo_act = jnp.sum(spow, axis=0) > jnp.float32(1e-3)  # [C]
        hnl = jnp.where(fifo_act[None], hnl, 1.0)
        gain = jnp.where(od > 0.0,
                         jnp.power(jnp.maximum(hnl, 1e-6), od),
                         jnp.ones_like(hnl)).astype(jnp.float32)
        out = jnp.fft.irfft(Ew * gain, n=nfft,
                            axis=0)[frame:].astype(jnp.float32)
        sd = sd.astype(jnp.float32)
        se = se.astype(jnp.float32)
        sx = sx.astype(jnp.float32)
        return (Wn, Xf, x, d, e, sd, se, sx, sde, sxd), out

    carry0 = (st["W"], st["Xf"], st["far_prev"], st["d_prev"],
              st["e_prev"], st["sd"], st["se"], st["sx"], st["sde"],
              st["sxd"])
    carry, out = lax.scan(step, carry0, (d_blocks, x_blocks))
    keys = ("W", "Xf", "far_prev", "d_prev", "e_prev", "sd", "se", "sx",
            "sde", "sxd")
    return out.reshape(n, c), dict(zip(keys, carry))


# ---------------------------------------------------------------------------
# pitch (ext/soundtouch/gstpitch.cc analog): phase-vocoder time stretch
# ---------------------------------------------------------------------------


def pv_init_state(frame: int, ha: int, hs: int, channels: int):
    bins = frame // 2 + 1
    return {
        "in_tail": jnp.zeros((frame - ha, channels), jnp.float32),
        "prev_ph": jnp.zeros((bins, channels), jnp.float32),
        "synth_ph": jnp.zeros((bins, channels), jnp.float32),
        "ola": jnp.zeros((frame - hs, channels), jnp.float32),
        "primed": jnp.bool_(False),
    }


def phase_vocoder(x: jnp.ndarray, state, frame: int, ha: int, hs: int):
    """Time-stretch x [N, C] by hs/ha with a Hann phase vocoder.

    Classic analysis/synthesis: per frame, the wrapped phase increment
    over the analysis hop gives the true bin frequency, which advances a
    carried synthesis phase by the synthesis hop (the SoundTouch
    time-stretch core is the WSOLA equivalent of this).  Framing is
    sequential only in phase (scanned over frames); FFTs batch."""
    n, c = x.shape
    f = n // ha
    buf = jnp.concatenate([state["in_tail"], x], axis=0)
    idx = jnp.arange(f)[:, None] * ha + jnp.arange(frame)[None, :]
    frames = buf[idx]                                # [F, frame, C]
    win = (0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(frame)
                               / frame)).astype(jnp.float32)
    spec = jnp.fft.rfft(frames * win[None, :, None], axis=1)
    mag = jnp.abs(spec).astype(jnp.float32)
    ph = jnp.angle(spec).astype(jnp.float32)

    bins = frame // 2 + 1
    omega = (2.0 * jnp.pi * jnp.arange(bins) / frame).astype(jnp.float32)
    expected = omega * ha

    def step(carry, inp):
        prev_ph, synth_ph, primed = carry
        m, p = inp
        dph = p - prev_ph - expected[:, None]
        dph = dph - 2.0 * jnp.pi * jnp.round(dph / (2.0 * jnp.pi))
        true_freq = omega[:, None] + dph / ha
        # first-ever frame: copy the analysis phase (no history yet)
        sp = jnp.where(primed, synth_ph + true_freq * hs, p)
        return (p, sp, jnp.bool_(True)), (m, sp)

    (prev_ph, synth_ph, primed), (mags, phases) = lax.scan(
        step, (state["prev_ph"], state["synth_ph"], state["primed"]),
        (mag, ph))
    out_frames = jnp.fft.irfft(mags * jnp.exp(1j * phases), n=frame,
                               axis=1).astype(jnp.float32)
    out_frames = out_frames * win[None, :, None]
    # hann^2 OLA at hop hs sums to (3/8) * frame / hs
    norm = 0.375 * frame / hs
    # overlap-add at hop hs
    total = f * hs + (frame - hs)
    out = jnp.zeros((total, c), jnp.float32)

    def ola_step(acc, inp):
        i, fr = inp
        start = (i * jnp.int32(hs), jnp.int32(0))
        return lax.dynamic_update_slice(
            acc, lax.dynamic_slice(acc, start, (frame, c)) + fr,
            start), None

    out, _ = lax.scan(ola_step, out,
                      (jnp.arange(f, dtype=jnp.int32), out_frames))
    out = out.at[: frame - hs].add(state["ola"])
    stretched = out[: f * hs] / norm
    new_state = {"in_tail": buf[n:], "prev_ph": prev_ph,
                 "synth_ph": synth_ph, "ola": out[f * hs:],
                 "primed": primed}
    return stretched, new_state


def resample_linear(x: jnp.ndarray, n_out: int):
    """[N, C] -> [n_out, C] linear resample spanning the whole input."""
    n = x.shape[0]
    pos = (jnp.arange(n_out, dtype=jnp.float32) + 0.5) * (n / n_out) - 0.5
    pos = jnp.clip(pos, 0.0, n - 1.0)
    i0 = jnp.floor(pos).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, n - 1)
    a = (pos - i0)[:, None]
    return x[i0] * (1.0 - a) + x[i1] * a


# ---------------------------------------------------------------------------
# adpcmdec (gst/adpcmdec/adpcmdec.c) — IMA/DVI and Microsoft ADPCM
# ---------------------------------------------------------------------------

IMA_INDEX_ADJUST = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)
IMA_STEP_SIZE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)
MS_ADAPTATION = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                          768, 614, 512, 409, 307, 230, 230, 230], np.int32)
MS_COEFF1 = np.array([256, 512, 0, 192, 240, 460, 392], np.int32)
MS_COEFF2 = np.array([0, -256, 0, 64, 0, -208, -232], np.int32)


def _rd16s(b, off):
    v = b[:, off] | (b[:, off + 1] << 8)
    return ((v + 32768) % 65536) - 32768


def adpcm_ima_decode(blocks: jnp.ndarray, channels: int) -> jnp.ndarray:
    """uint8 [B, blocksize] -> int16 [B, n, C].  The decode recurrences
    (stepindex walk + clamped sample accumulation,
    adpcmdec.c:302-328) are sequential per channel but independent across
    blocks and channels, so ONE scan over nibble positions runs the whole
    window vectorized [B, C]."""
    b = blocks.astype(jnp.int32)
    bsz = blocks.shape[1]
    n_groups = (bsz - 4 * channels) // (4 * channels)
    hdr = b[:, : 4 * channels].reshape(-1, channels, 4)
    v = hdr[..., 0] | (hdr[..., 1] << 8)
    s0 = ((v + 32768) % 65536) - 32768                 # [B, C]
    si0 = jnp.minimum(hdr[..., 2], 88)
    body = b[:, 4 * channels:].reshape(-1, n_groups, channels, 4)
    ch_bytes = jnp.moveaxis(body, 2, 1).reshape(-1, channels, n_groups * 4)
    codes = jnp.stack([ch_bytes & 0x0F, (ch_bytes >> 4) & 0x0F],
                      axis=-1).reshape(-1, channels, n_groups * 8)
    step_tab = jnp.asarray(IMA_STEP_SIZE)
    adj = jnp.asarray(IMA_INDEX_ADJUST)

    def step(carry, code):
        s, si = carry
        stepv = step_tab[si]
        diff = (2 * (code & 7) * stepv + stepv) // 8
        diff = jnp.where((code & 8) != 0, -diff, diff)
        s = jnp.clip(s + diff, -32768, 32767)
        si = jnp.clip(si + adj[code], 0, 88)
        return (s, si), s

    _, seq = lax.scan(step, (s0, si0), jnp.moveaxis(codes, 2, 0))
    out = jnp.concatenate([s0[None], seq], axis=0)     # [1+8G, B, C]
    return jnp.moveaxis(out, 0, 1).astype(jnp.int16)


def adpcm_ms_decode(blocks: jnp.ndarray, channels: int) -> jnp.ndarray:
    """uint8 [B, blocksize] -> int16 [B, n, C]
    (adpcmdec_decode_ms_block, adpcmdec.c:180-252)."""
    b = blocks.astype(jnp.int32)
    if channels == 1:
        pred = b[:, 0:1]
        delta0 = _rd16s(b, 1)[:, None]
        s1 = _rd16s(b, 3)[:, None]   # samples[1] (newer)
        s2 = _rd16s(b, 5)[:, None]   # samples[0]
        init_out = jnp.concatenate([s2, s1], axis=1)   # output order 0,1
        data_off = 7
    else:
        pred = b[:, 0:2]
        delta0 = jnp.stack([_rd16s(b, 2), _rd16s(b, 4)], axis=1)
        s2_, s3_ = _rd16s(b, 6), _rd16s(b, 8)
        s0_, s1_ = _rd16s(b, 10), _rd16s(b, 12)
        s1 = jnp.stack([s2_, s3_], axis=1)             # samples[2],[3]
        s2 = jnp.stack([s0_, s1_], axis=1)             # samples[0],[1]
        init_out = jnp.stack([s0_, s1_, s2_, s3_], axis=1)
        data_off = 14
    coef1 = jnp.asarray(MS_COEFF1)[pred]               # [B, C]
    coef2 = jnp.asarray(MS_COEFF2)[pred]
    adapt = jnp.asarray(MS_ADAPTATION)
    body = b[:, data_off:]
    codes = jnp.stack([(body >> 4) & 0x0F, body & 0x0F],
                      axis=-1).reshape(b.shape[0], -1, channels)

    def step(carry, code):
        s1, s2, delta = carry
        # gint16 idelta in C: wrap the product to 16 bits before the floor
        nd = (adapt[code] * delta) >> 8
        nd = ((nd + 32768) % 65536) - 32768
        new_delta = jnp.maximum(nd, 16)
        signed = code - jnp.where((code & 8) != 0, 16, 0)
        predict = (s1 * coef1 + s2 * coef2) >> 8
        cur = jnp.clip(signed * delta + predict, -32768, 32767)
        return (cur, s1, new_delta), cur

    _, seq = lax.scan(step, (s1, s2, delta0), jnp.moveaxis(codes, 1, 0))
    out = jnp.concatenate([init_out.reshape(-1, 2, channels),
                           jnp.moveaxis(seq, 0, 1)], axis=1)
    return out.astype(jnp.int16)


def adpcm_ima_encode(samples: jnp.ndarray, step_index0: jnp.ndarray):
    """int16 [B, n, C] -> (codes int32 [B, n, C], header_si [B, C],
    new step_index [C]).

    adpcmenc_encode_ima_sample (adpcmenc.c): the quantizer's 3-bit
    magnitude search unrolls to static mask steps; prev_sample resets to
    the header sample at each block start while step_index carries across
    blocks, so the scan runs over the flattened window with a
    block-start reset mask.  codes[:, 0, :] are dummies (the header slot);
    header_si is the carried step_index at each block's header."""
    b, n, c = samples.shape
    flat = samples.reshape(b * n, c).astype(jnp.int32)
    starts = (jnp.arange(b * n) % n) == 0
    tab = jnp.asarray(IMA_STEP_SIZE)
    adj = jnp.asarray(IMA_INDEX_ADJUST)

    def step(carry, inp):
        prev, si = carry
        s, start = inp
        diff0 = s - prev
        sign = diff0 < 0
        diff = jnp.abs(diff0)
        stepv = tab[si]
        vpdiff = stepv >> 3
        code = jnp.zeros_like(s)
        for bit in (4, 2, 1):
            ge = diff >= stepv
            code = code | jnp.where(ge, bit, 0)
            diff = diff - jnp.where(ge, stepv, 0)
            vpdiff = vpdiff + jnp.where(ge, stepv, 0)
            stepv = stepv >> 1
        code = code | jnp.where(sign, 8, 0)
        vp = jnp.where(sign, -vpdiff, vpdiff)
        new_prev = jnp.clip(prev + vp, -32768, 32767)
        new_si = jnp.clip(si + adj[code], 0, 88)
        prev_out = jnp.where(start, s, new_prev)
        si_out = jnp.where(start, si, new_si)
        return (prev_out, si_out), (jnp.where(start, 0, code), si)

    init = (jnp.zeros((c,), jnp.int32),
            step_index0.astype(jnp.int32))
    (_, si_final), (codes, si_seen) = lax.scan(step, init, (flat, starts))
    header_si = si_seen.reshape(b, n, c)[:, 0, :]
    return codes.reshape(b, n, c), header_si, si_final
