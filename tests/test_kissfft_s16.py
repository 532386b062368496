"""Bit-exact kissfft FIXED_POINT=16 (ops/kissfft_s16.py).

The vectorized stage implementation is pinned against an INDEPENDENT
scalar transcription of the kissfft recursion (kf_work + kf_bfly2/3/4/5 +
kiss_fftr, written element-by-element below exactly as the C walks), and
against the round-2 scale model within per-butterfly rounding noise.
"""

import numpy as np
import pytest

from gstbad.ops import kissfft_s16 as K


def sround(x):
    return (int(x) + (1 << 14)) >> 15


def cmul(a, b):
    return (sround(a[0] * b[0] - a[1] * b[1]),
            sround(a[0] * b[1] + a[1] * b[0]))


def fixdiv(c, k):
    s = 32767 // k
    return (sround(c[0] * s), sround(c[1] * s))


def scalar_kiss_fft(x, ncfft, tw):
    """kf_work (kiss_fft.c) scalar transcription; x = list of (r, i)."""
    factors = K.kf_factor(ncfft)
    ms = []
    sub = ncfft
    for p in factors:
        sub //= p
        ms.append(sub)
    out = [None] * ncfft

    def bfly2(F, o, fstride, m):
        for k in range(m):
            f0 = fixdiv(F[o + k], 2)
            f1 = fixdiv(F[o + m + k], 2)
            t = cmul(f1, tw[fstride * k])
            F[o + k] = (f0[0] + t[0], f0[1] + t[1])
            F[o + m + k] = (f0[0] - t[0], f0[1] - t[1])

    def bfly4(F, o, fstride, m):
        for k in range(m):
            f0 = fixdiv(F[o + k], 4)
            f1 = fixdiv(F[o + m + k], 4)
            f2 = fixdiv(F[o + 2 * m + k], 4)
            f3 = fixdiv(F[o + 3 * m + k], 4)
            s0 = cmul(f1, tw[fstride * k])
            s1 = cmul(f2, tw[2 * fstride * k])
            s2 = cmul(f3, tw[3 * fstride * k])
            s5 = (f0[0] - s1[0], f0[1] - s1[1])
            f0 = (f0[0] + s1[0], f0[1] + s1[1])
            s3 = (s0[0] + s2[0], s0[1] + s2[1])
            s4 = (s0[0] - s2[0], s0[1] - s2[1])
            F[o + 2 * m + k] = (f0[0] - s3[0], f0[1] - s3[1])
            F[o + k] = (f0[0] + s3[0], f0[1] + s3[1])
            F[o + m + k] = (s5[0] + s4[1], s5[1] - s4[0])
            F[o + 3 * m + k] = (s5[0] - s4[1], s5[1] + s4[0])

    def bfly3(F, o, fstride, m):
        epi3_i = tw[fstride * m][1]
        for k in range(m):
            f0 = fixdiv(F[o + k], 3)
            f1 = fixdiv(F[o + m + k], 3)
            f2 = fixdiv(F[o + 2 * m + k], 3)
            s1 = cmul(f1, tw[fstride * k])
            s2 = cmul(f2, tw[2 * fstride * k])
            s3 = (s1[0] + s2[0], s1[1] + s2[1])
            s0 = (s1[0] - s2[0], s1[1] - s2[1])
            fm = (f0[0] - (s3[0] >> 1), f0[1] - (s3[1] >> 1))
            s0 = (sround(s0[0] * epi3_i), sround(s0[1] * epi3_i))
            F[o + k] = (f0[0] + s3[0], f0[1] + s3[1])
            F[o + 2 * m + k] = (fm[0] + s0[1], fm[1] - s0[0])
            F[o + m + k] = (fm[0] - s0[1], fm[1] + s0[0])

    def bfly5(F, o, fstride, m):
        ya = tw[fstride * m]
        yb = tw[fstride * 2 * m]
        for u in range(m):
            f = [fixdiv(F[o + q * m + u], 5) for q in range(5)]
            s0 = f[0]
            mm = [cmul(f[q], tw[q * u * fstride]) for q in range(1, 5)]
            s7 = (mm[0][0] + mm[3][0], mm[0][1] + mm[3][1])
            s10 = (mm[0][0] - mm[3][0], mm[0][1] - mm[3][1])
            s8 = (mm[1][0] + mm[2][0], mm[1][1] + mm[2][1])
            s9 = (mm[1][0] - mm[2][0], mm[1][1] - mm[2][1])
            F[o + u] = (s0[0] + s7[0] + s8[0], s0[1] + s7[1] + s8[1])
            s5 = (s0[0] + sround(s7[0] * ya[0]) + sround(s8[0] * yb[0]),
                  s0[1] + sround(s7[1] * ya[0]) + sround(s8[1] * yb[0]))
            s6 = (sround(s10[1] * ya[1]) + sround(s9[1] * yb[1]),
                  -sround(s10[0] * ya[1]) - sround(s9[0] * yb[1]))
            F[o + m + u] = (s5[0] - s6[0], s5[1] - s6[1])
            F[o + 4 * m + u] = (s5[0] + s6[0], s5[1] + s6[1])
            s11 = (s0[0] + sround(s7[0] * yb[0]) + sround(s8[0] * ya[0]),
                   s0[1] + sround(s7[1] * yb[0]) + sround(s8[1] * ya[0]))
            s12 = (-sround(s10[1] * yb[1]) + sround(s9[1] * ya[1]),
                   sround(s10[0] * yb[1]) - sround(s9[0] * ya[1]))
            F[o + 2 * m + u] = (s11[0] + s12[0], s11[1] + s12[1])
            F[o + 3 * m + u] = (s11[0] - s12[0], s11[1] - s12[1])

    bflys = {2: bfly2, 3: bfly3, 4: bfly4, 5: bfly5}

    def work(o, f_idx, fstride, d):
        p, m = factors[d], ms[d]
        if m == 1:
            for q in range(p):
                out[o + q] = x[f_idx + q * fstride]
        else:
            for q in range(p):
                work(o + q * m, f_idx + q * fstride, fstride * p, d + 1)
        bflys[p](out, o, fstride, m)

    work(0, 0, 1, 0)
    return out


def scalar_kiss_fftr(x, nfft):
    ncfft = nfft // 2
    _, _, _, _, tw_r, tw_i, stw_r, stw_i = K._plan(ncfft)
    tw = list(zip(tw_r.tolist(), tw_i.tolist()))
    cin = [(int(x[2 * i]), int(x[2 * i + 1])) for i in range(ncfft)]
    t = scalar_kiss_fft(cin, ncfft, tw)
    out = [(0, 0)] * (ncfft + 1)
    tdc = fixdiv(t[0], 2)
    out[0] = (tdc[0] + tdc[1], 0)
    out[ncfft] = (tdc[0] - tdc[1], 0)
    for k in range(1, ncfft // 2 + 1):
        fpk = fixdiv(t[k], 2)
        fpnk = fixdiv((t[ncfft - k][0], -t[ncfft - k][1]), 2)
        f1k = (fpk[0] + fpnk[0], fpk[1] + fpnk[1])
        f2k = (fpk[0] - fpnk[0], fpk[1] - fpnk[1])
        twv = cmul(f2k, (int(stw_r[k - 1]), int(stw_i[k - 1])))
        out[k] = ((f1k[0] + twv[0]) >> 1, (f1k[1] + twv[1]) >> 1)
        out[ncfft - k] = ((f1k[0] - twv[0]) >> 1, (twv[1] - f1k[1]) >> 1)
    return out


@pytest.mark.parametrize("nfft", [32, 64, 128, 256, 40, 96, 160])
def test_vectorized_matches_scalar_transcription(rng, nfft):
    """Radix mixes: 32->(4,4), 256->(4,4,4,2), 40->(4,5), 96->(4,4,3),
    160->(4,4,5)."""
    x = rng.integers(-32768, 32768, nfft, dtype=np.int64).astype(np.int32)
    want = scalar_kiss_fftr(x, nfft)
    r, i = K.kiss_fftr_s16(np, x, nfft)
    np.testing.assert_array_equal(r, np.asarray([w[0] for w in want]))
    np.testing.assert_array_equal(i, np.asarray([w[1] for w in want]))


def test_batched_jax_matches_numpy(rng):
    import jax.numpy as jnp
    x = rng.integers(-32768, 32768, (5, 128), dtype=np.int64
                     ).astype(np.int32)
    rn, in_ = K.kiss_fftr_s16(np, x, 128)
    rj, ij = K.kiss_fftr_s16(jnp, jnp.asarray(x), 128)
    np.testing.assert_array_equal(np.asarray(rj), rn)
    np.testing.assert_array_equal(np.asarray(ij), in_)


def test_tracks_scale_model_within_rounding(rng):
    """The exact fixed-point spectra track the round-2 float scale model
    within per-butterfly rounding noise (a few LSB at nfft=256)."""
    from gstbad.golden import ffts16 as g
    x = (20000 * np.sin(2 * np.pi * 13 * np.arange(256) / 256)
         ).astype(np.int16)
    exact = g.fft_s16(x)
    model = g.fft_s16_scale_model(x)
    assert np.abs(exact - model).max() <= 8


def test_impulse_response():
    """FFT of a delta is flat at the aggregate fixed-point scale."""
    from gstbad.golden.ffts16 import fft_scale
    x = np.zeros(128, np.int16)
    x[0] = 32767
    r, i = K.kiss_fftr_s16(np, x.astype(np.int32), 128)
    expect = 32767 * fft_scale(128)
    assert np.all(np.abs(r.astype(float) - expect) <= 4)
    assert np.all(np.abs(i) <= 4)
