"""Golden transcriptions of the audio DSP chain: audiomixmatrix, freeverb,
audiochannelmix, and the removesilence VAD."""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# audiomixmatrix (gst/audiomixmatrix/gstaudiomixmatrix.c)
# ---------------------------------------------------------------------------


def mixmatrix_first_channels(in_ch: int, out_ch: int) -> np.ndarray:
    """First-channels mode: truncated identity (gstaudiomixmatrix.c:91-110)."""
    m = np.zeros((out_ch, in_ch))
    for i in range(min(in_ch, out_ch)):
        m[i, i] = 1.0
    return m


def mixmatrix_f32(x: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """F32 path (gstaudiomixmatrix.c:436-457): float32 accumulation of
    in * double-matrix per output channel.  x: [S, in_ch] float32."""
    acc = np.zeros((x.shape[0], matrix.shape[0]), np.float32)
    for i in range(matrix.shape[1]):
        acc += (x[:, i:i + 1] * matrix[:, i][None, :].astype(np.float32)
                ).astype(np.float32)
    return acc


def mixmatrix_f64(x: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    return (x.astype(np.float64) @ matrix.T).astype(np.float64)


def _shift_bytes_s16(in_ch: int) -> int:
    """gstaudiomixmatrix.c:256: 32 - 16 - 1 - ceil(log2(in_channels))."""
    return 32 - 16 - 1 - int(np.ceil(np.log(in_ch) / np.log(2)))


def _shift_bytes_s32(in_ch: int) -> int:
    """gstaudiomixmatrix.c:274: 64 - 32 - 1 - (gint)(log2(in_channels))
    (note: truncation, not ceil, in the reference)."""
    return 64 - 32 - 1 - int(np.log(in_ch) / np.log(2))


def mixmatrix_s16(x: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """S16 path (gstaudiomixmatrix.c:480-501): fixed-point via
    conv = (gint32)(m * (1 << shift)), gint32 accumulation with C wraparound,
    out = (gint16)(sum >> shift) (low 16 bits)."""
    n = _shift_bytes_s16(matrix.shape[1])
    conv = (matrix * (1 << n)).astype(np.int32)
    # gint16 * gint32 product wraps in int32; the sum wraps in int32 too
    prod = (x.astype(np.int64)[:, None, :]
            * conv.astype(np.int64)[None, :, :])
    prod32 = prod.astype(np.int32)  # wrap each term as the C product does
    acc = prod32.astype(np.int64).sum(axis=-1).astype(np.int32)
    return (acc >> n).astype(np.int16)  # low 16 bits, like the C cast


def mixmatrix_s32(x: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """S32 path (gstaudiomixmatrix.c:504-525): gint64 conv coefficients,
    gint64 wrapping accumulation, out = (gint32)(sum >> shift)."""
    n = _shift_bytes_s32(matrix.shape[1])
    conv = (matrix * (1 << n)).astype(np.int64)
    prod = x.astype(np.int64)[:, None, :] * conv[None, :, :]
    acc = prod.sum(axis=-1)
    return (acc >> n).astype(np.int32)


def audiochannelmix(x: np.ndarray, ll=1.0, lr=0.0, rl=0.0, rr=1.0) -> np.ndarray:
    """gst_audio_channel_mix_transform_ip (gstaudiochannelmix.c:222-251):
    S16 stereo, rint rounding, clamp. x: [S, 2] int16."""
    l = x[:, 0].astype(np.float64)
    r = x[:, 1].astype(np.float64)
    out = np.empty_like(x)
    out[:, 0] = np.clip(np.rint(ll * l + rl * r), -32768, 32767)
    out[:, 1] = np.clip(np.rint(lr * l + rr * r), -32768, 32767)
    return out


# ---------------------------------------------------------------------------
# freeverb (gst/freeverb/gstfreeverb.c)
# ---------------------------------------------------------------------------

DC_OFFSET = 1e-8
FIXEDGAIN = np.float32(0.015)
SCALEROOM = 0.28
OFFSETROOM = 0.7
STEREOSPREAD = 23
COMB_L = [1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617]
ALLPASS_L = [556, 441, 341, 225]


class Freeverb:
    """Schroeder/Moorer model state (gstfreeverb.c:288-330,483-530).

    8 parallel combs + 4 series allpasses per channel; R-channel delay lines
    are offset by stereospread samples; buffer lengths scale by rate/44100.
    All arithmetic is float32 to match the C floats.
    """

    def __init__(self, rate=44100, room_size=0.5, damping=0.2, width=1.0,
                 level=0.5):
        srfactor = rate / 44100.0
        self.gain = FIXEDGAIN
        sizes_l = [int(t * srfactor) for t in COMB_L]
        sizes_r = [int((t + STEREOSPREAD) * srfactor) for t in COMB_L]
        ap_l = [int(t * srfactor) for t in ALLPASS_L]
        ap_r = [int((t + STEREOSPREAD) * srfactor) for t in ALLPASS_L]
        mk = lambda n: np.full(n, np.float32(DC_OFFSET), np.float32)
        self.combL = [{"buf": mk(n), "idx": 0, "store": np.float32(0)}
                      for n in sizes_l]
        self.combR = [{"buf": mk(n), "idx": 0, "store": np.float32(0)}
                      for n in sizes_r]
        self.apL = [{"buf": mk(n), "idx": 0} for n in ap_l]
        self.apR = [{"buf": mk(n), "idx": 0} for n in ap_r]
        self.set_params(room_size, damping, width, level)

    def set_params(self, room_size, damping, width, level):
        self.feedback = np.float32(room_size * SCALEROOM + OFFSETROOM)
        self.damp1 = np.float32(damping * 1.0)
        self.damp2 = np.float32(1 - self.damp1)
        self.wet = np.float32(level * 1.0)
        self.dry = np.float32((1.0 - level) * 1.0)
        self.width = np.float32(width)
        self.wet1 = np.float32(self.wet * (self.width / np.float32(2.0)
                                           + np.float32(0.5)))
        self.wet2 = np.float32(self.wet * ((np.float32(1.0) - self.width)
                                           / np.float32(2.0)))

    def _comb(self, c, inp, out):
        tmp = c["buf"][c["idx"]]
        c["store"] = np.float32(tmp * self.damp2 + c["store"] * self.damp1)
        c["buf"][c["idx"]] = np.float32(inp + c["store"] * self.feedback)
        c["idx"] = (c["idx"] + 1) % len(c["buf"])
        return np.float32(out + tmp)

    def _allpass(self, a, inp):
        bufout = a["buf"][a["idx"]]
        output = np.float32(bufout - inp)
        a["buf"][a["idx"]] = np.float32(inp + bufout * np.float32(0.5))
        a["idx"] = (a["idx"] + 1) % len(a["buf"])
        return output

    def process_stereo_float(self, x: np.ndarray) -> np.ndarray:
        """gst_freeverb_transform_s2s_float (gstfreeverb.c:845+).
        x: [S, 2] float32 -> [S, 2] float32."""
        out = np.empty_like(x, np.float32)
        for k in range(x.shape[0]):
            in2l = np.float32(x[k, 0])
            in2r = np.float32(x[k, 1])
            in1l = np.float32((in2l + np.float32(DC_OFFSET)) * self.gain)
            in1r = np.float32((in2r + np.float32(DC_OFFSET)) * self.gain)
            outl = np.float32(0)
            outr = np.float32(0)
            for i in range(8):
                outl = self._comb(self.combL[i], in1l, outl)
                outr = self._comb(self.combR[i], in1r, outr)
            for i in range(4):
                outl = self._allpass(self.apL[i], outl)
                outr = self._allpass(self.apR[i], outr)
            outl = np.float32(outl - np.float32(DC_OFFSET))
            outr = np.float32(outr - np.float32(DC_OFFSET))
            out[k, 0] = np.float32(outl * self.wet1 + outr * self.wet2
                                   + in2l * self.dry)
            out[k, 1] = np.float32(outr * self.wet1 + outl * self.wet2
                                   + in2r * self.dry)
        return out

    def process_mono_float(self, x: np.ndarray) -> np.ndarray:
        """gst_freeverb_transform_m2s_float (gstfreeverb.c:790-840):
        mono in, stereo out; input doubled."""
        out = np.empty((x.shape[0], 2), np.float32)
        for k in range(x.shape[0]):
            in2 = np.float32(x[k])
            in1 = np.float32((np.float32(2.0) * in2 + np.float32(DC_OFFSET))
                             * self.gain)
            outl = np.float32(0)
            outr = np.float32(0)
            for i in range(8):
                outl = self._comb(self.combL[i], in1, outl)
                outr = self._comb(self.combR[i], in1, outr)
            for i in range(4):
                outl = self._allpass(self.apL[i], outl)
                outr = self._allpass(self.apR[i], outr)
            outl = np.float32(outl - np.float32(DC_OFFSET))
            outr = np.float32(outr - np.float32(DC_OFFSET))
            out[k, 0] = np.float32(outl * self.wet1 + outr * self.wet2
                                   + in2 * self.dry)
            out[k, 1] = np.float32(outr * self.wet1 + outl * self.wet2
                                   + in2 * self.dry)
        return out

    def process_stereo_s16(self, x: np.ndarray) -> np.ndarray:
        """gst_freeverb_transform_s2s_int (gstfreeverb.c:741-787)."""
        xf = x.astype(np.float32)
        y = self.process_stereo_float(xf)
        return np.clip(np.trunc(y), -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# removesilence VAD (gst/removesilence/vad_private.c)
# ---------------------------------------------------------------------------

VAD_POWER_ALPHA = 0x0800
VAD_BUFFER_SIZE = 256
VAD_SILENCE = 0
VAD_VOICE = 1


class VAD:
    """vad_update (vad_private.c:117-160), exact integer transcription."""

    def __init__(self, hysteresis=480, threshold_db=-60):
        self.ring = np.zeros(VAD_BUFFER_SIZE, np.int16)
        self.head = 0
        self.tail = 0
        self.state = VAD_SILENCE
        self.hysteresis = hysteresis
        self.samples = 0
        self.power = 0
        self.set_threshold(threshold_db)

    def set_threshold(self, threshold_db):
        # vad_private.c:105-114: integer dB decade then scale to Q32
        power = int(threshold_db / 10.0)
        self.threshold = int((10.0 ** power) * 4294967295)

    def update(self, data: np.ndarray) -> int:
        data = data.astype(np.int16)
        for v in data.tolist():
            sq = (v * v) >> 14
            self.power = (VAD_POWER_ALPHA * (sq & 0xFFFF)
                          + (0xFFFF - VAD_POWER_ALPHA) * (self.power >> 16)
                          + ((0xFFFF - VAD_POWER_ALPHA)
                             * (self.power & 0xFFFF) >> 16))
            self.ring[self.head] = v
            self.head = (self.head + 1) & (VAD_BUFFER_SIZE - 1)
            if self.head == self.tail:
                self.tail = (self.tail + 1) & (VAD_BUFFER_SIZE - 1)
        zcr = 0
        tail = self.tail
        while True:
            s = int(self.ring[tail])
            tail = (tail + 1) & (VAD_BUFFER_SIZE - 1)
            if tail == self.head:
                break
            nxt = int(self.ring[tail])
            zcr += 1 if ((s & 0x8000 != 0) != (nxt & 0x8000 != 0)) else -1
        frame_type = (VAD_VOICE if (self.power > self.threshold and zcr < 0)
                      else VAD_SILENCE)
        if self.state != frame_type:
            if self.state == VAD_VOICE:
                self.samples += len(data)
                if self.samples >= self.hysteresis:
                    self.state = frame_type
                    self.samples = 0
            else:
                self.state = frame_type
                self.samples = 0
        else:
            self.samples = 0
        return self.state


# ---------------------------------------------------------------------------
# bs2b crossfeed (ext/bs2b/gstbs2b.c; DSP = public-domain libbs2b)
# ---------------------------------------------------------------------------

BS2B_PRESETS = {
    # name -> (fcut Hz, feed dB*10); gstbs2b.c:85-98 preset table
    # (BS2B_DEFAULT/CMOY/JMEIER_CLEVEL packed fcut | feed<<16)
    "default": (700, 45),
    "cmoy": (700, 60),
    "jmeier": (650, 95),
}


class Bs2b:
    """Sample-serial float64 transcription of libbs2b's cross_feed_d.

    The element (ext/bs2b/gstbs2b.c) delegates all DSP to the external
    libbs2b; this is the spec for our JAX rebuild.  Filter design follows
    libbs2b init(): the feed level (dB*10) splits into lowpass attenuation
    GB_lo = -level*5/6 - 3 and high-boost GB_hi = level/6 - 3; one-pole
    lowpass at fcut feeds the opposite channel, a matching one-pole
    high-boost keeps the direct channel, and gain renormalizes.
    """

    def __init__(self, rate=44100, fcut=700, feed=45):
        level = feed / 10.0
        gb_lo = level * -5.0 / 6.0 - 3.0
        gb_hi = level / 6.0 - 3.0
        g_lo = 10.0 ** (gb_lo / 20.0)
        g_hi = 1.0 - 10.0 ** (gb_hi / 20.0)
        fc_hi = fcut * 2.0 ** ((gb_lo - 20.0 * np.log10(g_hi)) / 12.0)
        x = np.exp(-2.0 * np.pi * fcut / rate)
        self.b1_lo, self.a0_lo = x, g_lo * (1.0 - x)
        x = np.exp(-2.0 * np.pi * fc_hi / rate)
        self.b1_hi, self.a0_hi, self.a1_hi = x, 1.0 - g_hi * (1.0 - x), -x
        self.gain = 1.0 / (1.0 - g_hi + g_lo)
        self.lo = np.zeros(2)
        self.hi = np.zeros(2)
        self.asis = np.zeros(2)

    def process_float(self, x: np.ndarray) -> np.ndarray:
        """x: [N, 2] float64 (any native scale; libbs2b runs int formats
        unnormalized and clips afterwards)."""
        out = np.empty_like(x, np.float64)
        for n in range(x.shape[0]):
            for ch in (0, 1):
                self.lo[ch] = self.a0_lo * x[n, ch] + self.b1_lo * self.lo[ch]
                self.hi[ch] = (self.a0_hi * x[n, ch]
                               + self.a1_hi * self.asis[ch]
                               + self.b1_hi * self.hi[ch])
                self.asis[ch] = x[n, ch]
            out[n, 0] = (self.hi[0] + self.lo[1]) * self.gain
            out[n, 1] = (self.hi[1] + self.lo[0]) * self.gain
        return out

    def process_s16(self, x: np.ndarray) -> np.ndarray:
        """bs2b_cross_feed_s16: process in native int range, clip, trunc."""
        y = self.process_float(x.astype(np.float64))
        return np.clip(y, -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# adpcmdec (gst/adpcmdec/adpcmdec.c)
# ---------------------------------------------------------------------------

IMA_INDEX_ADJUST = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8])  # :254-256
IMA_STEP_SIZE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767])  # :258-272
MS_ADAPTATION = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                          768, 614, 512, 409, 307, 230, 230, 230])
MS_COEFF1 = np.array([256, 512, 0, 192, 240, 460, 392])
MS_COEFF2 = np.array([0, -256, 0, 64, 0, -208, -232])


def _rd16(data, off):
    # plain ints: uint8 << 8 would wrap to zero; manual two's complement
    v = int(data[off]) | (int(data[off + 1]) << 8)
    return v - 65536 if v >= 32768 else v


def adpcm_decode_ima_block(data: np.ndarray, channels: int) -> np.ndarray:
    """adpcmdec_decode_ima_block (adpcmdec.c:274-331), interleaved int16."""
    n_samples = (len(data) - 4 * channels) * 2 + channels
    samples = np.zeros(n_samples, np.int64)
    stepindex = np.zeros(channels, np.int64)
    for c in range(channels):
        samples[c] = _rd16(data, c * 4)
        stepindex[c] = min(data[c * 4 + 2], 88)
        assert data[c * 4 + 3] == 0, "synchronisation error"
    i = channels
    idx = 4 * channels
    while i < n_samples:
        for c in range(channels):
            sample = i + c
            for j in range(8):
                if j % 2 == 0:
                    code = int(data[idx]) & 0x0F
                else:
                    code = int(data[idx] >> 4) & 0x0F
                    idx += 1
                step = IMA_STEP_SIZE[stepindex[c]]
                diff = (2 * (code & 0x7) * step + step) // 8
                if code & 8:
                    diff = -diff
                samples[sample] = np.clip(samples[sample - channels] + diff,
                                          -32768, 32767)
                stepindex[c] = np.clip(stepindex[c]
                                       + IMA_INDEX_ADJUST[code], 0, 88)
                sample += channels
        i += 8 * channels
    return samples.astype(np.int16)


def adpcm_decode_ms_block(data: np.ndarray, channels: int) -> np.ndarray:
    """adpcmdec_decode_ms_block (adpcmdec.c:180-252), interleaved int16."""
    n_samples = (len(data) - 7 * channels) * 2 + 2 * channels
    samples = np.zeros(n_samples, np.int64)
    if channels == 1:
        pred = [data[0]]
        idelta = [int(_rd16(data, 1))]
        samples[1] = _rd16(data, 3)
        samples[0] = _rd16(data, 5)
        idx, i = 7, 2
    else:
        pred = [data[0], data[1]]
        idelta = [int(_rd16(data, 2)), int(_rd16(data, 4))]
        samples[2] = _rd16(data, 6)
        samples[3] = _rd16(data, 8)
        samples[0] = _rd16(data, 10)
        samples[1] = _rd16(data, 12)
        idx, i = 14, 4
    assert all(0 <= p <= 6 for p in pred), "invalid block predictor"
    while i < n_samples:
        chan = i % channels
        if i % 2 == 0:
            code = int(data[idx] >> 4) & 0x0F
        else:
            code = int(data[idx]) & 0x0F
            idx += 1
        delta = idelta[chan]
        # C keeps idelta in gint16: the product truncates to 16 bits
        # BEFORE the < 16 floor (adpcmdec.c:185 'gint16 idelta[2]')
        nd = (int(MS_ADAPTATION[code]) * delta) >> 8
        nd = ((nd + 32768) % 65536) - 32768
        idelta[chan] = max(nd, 16)
        signed = code - 0x10 if code & 0x8 else code
        predict = ((int(samples[i - channels]) * int(MS_COEFF1[pred[chan]]))
                   + (int(samples[i - 2 * channels])
                      * int(MS_COEFF2[pred[chan]]))) >> 8
        samples[i] = np.clip(signed * delta + predict, -32768, 32767)
        i += 1
    return samples.astype(np.int16)


def adpcm_encode_ima_sample(sample, prev_sample, stepindex):
    """adpcmenc_encode_ima_sample (adpcmenc.c): returns (code, prev, si)."""
    diff = int(sample) - int(prev_sample)
    step = int(IMA_STEP_SIZE[stepindex])
    vpdiff = step >> 3
    code = 0
    if diff < 0:
        diff = -diff
        code = 0x8
    mask = 0x4
    while mask > 0:
        if diff >= step:
            code |= mask
            diff -= step
            vpdiff += step
        step >>= 1
        mask >>= 1
    if code & 8:
        vpdiff = -vpdiff
    prev = int(np.clip(prev_sample + vpdiff, -32768, 32767))
    si = int(np.clip(stepindex + IMA_INDEX_ADJUST[code], 0, 88))
    return code, prev, si


class AdpcmEncIma:
    """adpcmenc_encode_ima_block (adpcmenc.c): DVI layout; step_index
    carries across blocks, prev_sample resets to the header sample."""

    def __init__(self, channels: int):
        self.channels = channels
        self.step_index = [0] * channels

    def encode_block(self, samples: np.ndarray, blocksize: int) -> bytes:
        """samples: int16 [n, channels] with n = samples_per_block."""
        ch = self.channels
        out = bytearray(blocksize)
        prev = [0] * ch
        for c in range(ch):
            s0 = int(samples[0, c])
            out[c * 4 + 0] = s0 & 0xFF
            out[c * 4 + 1] = (s0 >> 8) & 0xFF
            out[c * 4 + 2] = self.step_index[c]
            out[c * 4 + 3] = 0
            prev[c] = s0
        wp = 4 * ch
        rp = 1
        while wp < blocksize:
            for c in range(ch):
                for j in range(0, 8, 2):
                    lo, prev[c], self.step_index[c] = \
                        adpcm_encode_ima_sample(samples[rp + j, c], prev[c],
                                                self.step_index[c])
                    hi, prev[c], self.step_index[c] = \
                        adpcm_encode_ima_sample(samples[rp + j + 1, c],
                                                prev[c], self.step_index[c])
                    out[wp] = (lo & 0x0F) | ((hi << 4) & 0xF0)
                    wp += 1
            rp += 8
        return bytes(out)


def speed_resample_indices(in_samples: int, speed: float):
    """The speed element's per-buffer resample walk
    (gst/speed/gstspeed.c:433-474 speed_chain_int16, :474-511 _float32).

    The reference restarts the walk on EVERY input buffer: i_float begins at
    0.5*(speed-1) and accumulates `+= speed` in gfloat; each output takes
    i = ceil(i_float), interp = i_float - floor(i_float), and blends
    `lower` (the previously selected input sample, in[0] initially) with
    in[i].  Returns (prev_idx, idx, interp_f32) arrays of the static output
    length for this buffer size."""
    i_float = np.float32(0.5 * (speed - 1.0))
    speed32 = np.float32(speed)
    i = int(np.ceil(np.float64(i_float)))
    prev_idx, idx, interp = [], [], []
    prev = 0
    while i < in_samples:
        interp.append(np.float32(np.float64(i_float)
                                 - np.floor(np.float64(i_float))))
        prev_idx.append(prev)
        idx.append(i)
        prev = i
        i_float = np.float32(i_float + speed32)
        i = int(np.ceil(np.float64(i_float)))
    return (np.array(prev_idx, np.int32), np.array(idx, np.int32),
            np.array(interp, np.float32))


def speed_resample(x: np.ndarray, speed: float) -> np.ndarray:
    """One buffer [S, C] through the speed walk; float32 in, float32 out
    (the int16 path casts the same gfloat result, C truncation)."""
    prev_idx, idx, interp = speed_resample_indices(x.shape[0], speed)
    xf = x.astype(np.float32)
    one = np.float32(1)
    return (xf[prev_idx] * (one - interp)[:, None]
            + xf[idx] * interp[:, None])
