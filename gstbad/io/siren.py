"""Siren7 (ITU-T G.722.1 / MS Wave format 0x028E) audio codec.

Transcription of the reference's in-tree DSP codec (gst/siren/): the RMLT
analysis/synthesis windows (rmlt.c:84-149), the staged DCT-IV
(dct4.c:91-199), the region power envelope + rate-control categorizer
(common.c:100-207, huffman.c:54-120), the vector huffman quantizer
(huffman.c:157-284) and the frame bitstream with its 4-bit checksum
(encoder.c:72-257, decoder.c:73-253).  The codebook constants are
extracted DATA (data/siren_tables.py, see data/README.md).

Frames are 320 samples (20 ms at 16 kHz) <-> 40 bytes (16 kbit/s), the
flag=1 configuration the reference elements use (gstsirendec.c caps).
All float math is float32 like the C; the DCT-IV stages are vectorized
numpy with the C's per-element operation order preserved.
"""

from __future__ import annotations

import numpy as np

from gstbad.data import siren_tables as T

REGION_SIZE = 20
_STEPSIZE = np.float32(0.3010299957)
_PI = 3.1415926  # the reference's low-precision PI (dct4.c:26)

EXPECTED_BITS = [52, 47, 43, 37, 29, 22, 16, 0]
VECTOR_DIMENSION = [2, 2, 2, 4, 4, 5, 5, 1]
NUMBER_OF_VECTORS = [10, 10, 10, 5, 5, 4, 4, 20]
DEAD_ZONE = [np.float32(v) for v in
             (0.3, 0.33, 0.36, 0.39, 0.42, 0.45, 0.5, 0.5)]
MAX_BIN = [13, 9, 6, 4, 3, 2, 1, 1]
STEP_SIZE = [np.float32(v) for v in
             (0.3536, 0.5, 0.70709997, 1.0, 1.4141999, 2.0,
              2.8283999, 2.8283999)]

_CHECKSUM_TABLE = (0x7F80, 0x7878, 0x6666, 0x5555)

_BITCOUNT = [np.asarray(t, np.int64) for t in (
    T.bitcount_table_category0, T.bitcount_table_category1,
    T.bitcount_table_category2, T.bitcount_table_category3,
    T.bitcount_table_category4, T.bitcount_table_category5,
    T.bitcount_table_category6)]
_CODES = [np.asarray(t, np.int64) for t in (
    T.code_table_category0, T.code_table_category1,
    T.code_table_category2, T.code_table_category3,
    T.code_table_category4, T.code_table_category5,
    T.code_table_category6)]
_DECODER_TREES = [np.asarray(t, np.int64) for t in (
    T.decoder_tree0, T.decoder_tree1, T.decoder_tree2, T.decoder_tree3,
    T.decoder_tree4, T.decoder_tree5, T.decoder_tree6)]
_MLT_QUANT = np.asarray(T.mlt_quant, np.float32)
_NOISE5 = np.asarray(T.noise_category5, np.float32)
_NOISE6 = np.asarray(T.noise_category6, np.float32)
_NOISE7 = np.float32(T.noise_category7)
_INDEX_TABLE = list(T.index_table)
_DIFF_TREE = np.asarray(T.differential_decoder_tree, np.int64)
_DRP_BITS = np.asarray(T.differential_region_power_bits, np.int64)
_DRP_CODES = np.asarray(T.differential_region_power_codes, np.int64)


# ---------------------------------------------------------------------------
# tables (siren_init, common.c:66-95; siren_dct4_init, dct4.c:57-88;
# siren_rmlt_init, rmlt.c:38-53)
# ---------------------------------------------------------------------------

_cache = {}


def _init():
    if _cache:
        return _cache
    i = np.arange(64)
    region_power = np.power(np.float32(10.0),
                            ((i - 24) * _STEPSIZE).astype(np.float32))
    _cache["std_dev"] = np.sqrt(region_power).astype(np.float32)
    _cache["dev_inv"] = (np.float32(1.0)
                         / _cache["std_dev"]).astype(np.float32)
    _cache["boundary"] = np.power(
        10.0, (np.arange(63) - 24 + 0.5) * float(_STEPSIZE)
    ).astype(np.float32)
    _cache["step_inv"] = np.asarray(
        [np.float32(1.0) / s for s in STEP_SIZE], np.float32)

    # dct4 core + twiddles
    for n, name in ((320, "core320"), (640, "core640")):
        scale = float(np.float32(np.sqrt(2.0 / n)))
        core = np.empty((10, 10), np.float32)
        for ii in range(10):
            angle = float(np.float32((ii + 0.5) * _PI))
            for j in range(10):
                core[ii, j] = np.float32(scale * np.cos((j + 0.5) * angle
                                                        / 10))
        _cache[name] = core
    tabs = []
    for k in range(8):
        scale = float(np.float32(_PI / ((5 << k) * 4)))
        j = np.arange(5 << k)
        angle = (j + 0.5).astype(np.float32).astype(np.float64) * scale
        tabs.append((np.cos(angle).astype(np.float32),
                     (-np.sin(angle)).astype(np.float32)))
    _cache["dct_tables"] = tabs

    for n, name in ((320, "win320"), (640, "win640")):
        idx = np.arange(n)
        angle = ((idx + 0.5) * (np.pi / 2) / n)
        _cache[name] = np.sin(angle).astype(np.float32)
    return _cache


def siren_dct4(src: np.ndarray, dct_length: int = 320) -> np.ndarray:
    """siren_dct4 (dct4.c:91-199): butterfly stages + 10x10 core + twiddle
    recombination, float32 with the C's per-element op order."""
    t = _init()
    log_length = 5 if dct_length == 640 else 4
    core = t["core640" if dct_length == 640 else "core320"]
    buf = src.astype(np.float32)

    # forward sum/diff stages (dct4.c:124-140)
    for i in range(log_length + 1):
        blocks = buf.reshape(1 << i, -1)       # [2^i, L]
        pairs = blocks.reshape(blocks.shape[0], -1, 2)
        s = pairs[:, :, 0] + pairs[:, :, 1]
        d = pairs[:, :, 0] - pairs[:, :, 1]
        buf = np.concatenate([s, d[:, ::-1]], axis=1).reshape(-1)

    # 10x10 core (dct4.c:142-160): strict left-to-right accumulation
    g = buf.reshape(-1, 10)
    acc = g[:, 0:1] * core[:, 0][None, :]
    for k in range(1, 10):
        acc = acc + g[:, k:k + 1] * core[:, k][None, :]
    buf = acc.reshape(-1)

    # twiddle recombination stages (dct4.c:163-196)
    tabs = t["dct_tables"]
    for i in range(log_length, -1, -1):
        table_idx = log_length - i + 1
        cos_t, msin_t = tabs[table_idx]
        bl = dct_length >> i
        half = bl >> 1
        blocks = buf.reshape(-1, bl)
        low = blocks[:, :half]
        high = blocks[:, half:]
        c = cos_t[None, :half]
        s = msin_t[None, :half]
        m = np.arange(half)
        sign = np.where((m & 1) == 0, np.float32(1), np.float32(-1))[None, :]
        front = low * c - sign * (high * s)
        back = low * s + sign * (high * c)
        out = np.empty_like(blocks)
        out[:, :half] = front
        out[:, half:] = back[:, ::-1]  # back[m] lands at position bl-1-m
        buf = out.reshape(-1)
    return buf


def rmlt_encode(samples: np.ndarray, old: np.ndarray, dct_length: int = 320):
    """siren_rmlt_encode_samples (rmlt.c:84-118); returns (coefs, new_old)."""
    t = _init()
    win = t["win640" if dct_length == 640 else "win320"]
    half = dct_length // 2
    s = samples.astype(np.float32)
    i = np.arange(half)
    coefs = np.empty(dct_length, np.float32)
    coefs[:half] = old[:half]
    coefs[half:] = (s[i] * win[dct_length - 1 - i]
                    - s[dct_length - 1 - i] * win[i])
    new_old = np.empty(half, np.float32)
    new_old[half - 1 - i] = (s[dct_length - 1 - i] * win[dct_length - 1 - i]
                             + s[i] * win[i])
    return siren_dct4(coefs, dct_length), new_old


def rmlt_decode(coefs: np.ndarray, old: np.ndarray, dct_length: int = 320):
    """siren_rmlt_decode_samples (rmlt.c:123-149); returns
    (samples, new_old)."""
    t = _init()
    win = t["win640" if dct_length == 640 else "win320"]
    half = dct_length // 2
    x = siren_dct4(coefs.astype(np.float32), dct_length)
    samples = np.empty(dct_length, np.float32)
    new_old = np.empty(half, np.float32)
    # the C loop steps i by 2 but each pointer by 1, so it runs half/2
    # iterations k with every pointer at offset k (rmlt.c:129-146)
    k = np.arange(half // 2)
    sample_low_val = x[k]
    sample_high_val = x[dct_length - 1 - k]
    sample_middle_low_val = x[half - 1 - k]
    sample_middle_high_val = x[half + k]
    old_low = old[k]
    old_high = old[half - 1 - k]
    samples[k] = (old_low * win[dct_length - 1 - k]
                  + sample_middle_low_val * win[k])
    samples[dct_length - 1 - k] = (sample_middle_low_val
                                   * win[dct_length - 1 - k]
                                   - old_low * win[k])
    samples[half + k] = (sample_low_val * win[half + k]
                         - old_high * win[half - 1 - k])
    samples[half - 1 - k] = (old_high * win[half + k]
                             + sample_low_val * win[half - 1 - k])
    new_old[k] = sample_middle_high_val
    new_old[half - 1 - k] = sample_high_val
    return samples, new_old


# ---------------------------------------------------------------------------
# codec configuration (GetSirenCodecInfo, common.c:219-504, flag 1)
# ---------------------------------------------------------------------------

def codec_info(sample_rate: int = 16000):
    codes = {16000: 1, 24000: 2, 32000: 3}
    if sample_rate not in codes:
        raise ValueError(f"siren7: unsupported rate {sample_rate}")
    return {
        "number_of_coefs": 320, "sample_rate_bits": 2,
        "rate_control_bits": 4, "rate_control_possibilities": 16,
        "checksum_bits": 4, "esf_adjustment": -2, "scale_factor": 1,
        "number_of_regions": 14, "sample_rate_code": codes[sample_rate],
        "bits_per_frame": sample_rate // 50,
    }


def categorize_regions(number_of_regions, number_of_available_bits, arpi):
    """categorize_regions (common.c:100-207)."""
    if number_of_regions == 14:
        num_rcp = 16
        if number_of_available_bits > 320:
            number_of_available_bits = ((number_of_available_bits - 320)
                                        * 5 // 8) + 320
    else:
        num_rcp = 32
        if number_of_regions == 28 and number_of_available_bits > 640:
            number_of_available_bits = ((number_of_available_bits - 640)
                                        * 5 // 8) + 640
    offset = -32
    delta = 32
    power_categories = [0] * number_of_regions
    while number_of_regions > 0 and delta > 0:
        expected = 0
        for region in range(number_of_regions):
            i = (delta + offset - arpi[region]) >> 1
            i = 7 if i > 7 else (0 if i < 0 else i)
            power_categories[region] = i
            expected += EXPECTED_BITS[i]
        if expected >= number_of_available_bits - 32:
            offset += delta
        delta //= 2
    expected = 0
    max_rate = [0] * number_of_regions
    min_rate = [0] * number_of_regions
    for region in range(number_of_regions):
        i = (offset - arpi[region]) >> 1
        i = 7 if i > 7 else (0 if i < 0 else i)
        max_rate[region] = min_rate[region] = power_categories[region] = i
        expected += EXPECTED_BITS[i]
    lo = hi = expected
    temp_bal = [0] * 64
    min_ptr = max_ptr = num_rcp
    for _ in range(num_rcp - 1):
        if lo + hi > number_of_available_bits * 2:
            raw = -99
            raw_min = 0
            for region in range(number_of_regions - 1, -1, -1):
                if min_rate[region] < 7:
                    temp = offset - arpi[region] - 2 * min_rate[region]
                    if temp > raw:
                        raw = temp
                        raw_min = region
            temp_bal[min_ptr] = raw_min
            min_ptr += 1
            lo += (EXPECTED_BITS[min_rate[raw_min] + 1]
                   - EXPECTED_BITS[min_rate[raw_min]])
            min_rate[raw_min] += 1
        else:
            raw = 99
            raw_max = 0
            for region in range(number_of_regions):
                if max_rate[region] > 0:
                    temp = offset - arpi[region] - 2 * max_rate[region]
                    if temp < raw:
                        raw = temp
                        raw_max = region
            max_ptr -= 1
            temp_bal[max_ptr] = raw_max
            hi += (EXPECTED_BITS[max_rate[raw_max] - 1]
                   - EXPECTED_BITS[max_rate[raw_max]])
            max_rate[raw_max] -= 1
    power_categories = list(max_rate)
    category_balance = [temp_bal[max_ptr + i] for i in range(num_rcp - 1)]
    return power_categories, category_balance


def _checksum(words, bits_per_words, checksum_bits=4):
    s = 0
    for idx in range(bits_per_words):
        s ^= (words[idx] & 0xFFFF) << (idx % 15)
    s = (s >> 15) ^ (s & 0x7FFF)
    out = 0
    for i in range(4):
        t1 = _CHECKSUM_TABLE[i] & s
        j = 8
        while j > 0:
            t1 ^= t1 >> j
            j >>= 1
        out = (out << 1) | (t1 & 1)
    return out


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class SirenEncoder:
    """Siren7_NewEncoder/Siren7_EncodeFrame (encoder.c:47-257)."""

    def __init__(self, sample_rate: int = 16000):
        self.info = codec_info(sample_rate)
        self.context = np.zeros(160, np.float32)
        _init()

    def encode_frame(self, samples: np.ndarray) -> bytes:
        """320 int16 samples -> 40-byte frame."""
        info = self.info
        t = _init()
        x = np.asarray(samples, np.int16).astype(np.float32)
        assert x.shape == (320,)
        coefs, self.context = rmlt_encode(x, self.context, 320)

        drp_num_bits, drp_code_bits, arpi, envelope_bits = (
            self._compute_region_powers(coefs, info["esf_adjustment"],
                                        info["number_of_regions"]))
        available = (info["bits_per_frame"] - info["rate_control_bits"]
                     - envelope_bits - info["sample_rate_bits"]
                     - info["checksum_bits"])
        power_categories, category_balance = categorize_regions(
            info["number_of_regions"], available, arpi)
        arpi = [v + 24 for v in arpi]
        rate_control, region_bit_counts, region_bits = self._quantize_mlt(
            info["number_of_regions"], info["rate_control_possibilities"],
            available, coefs, arpi, power_categories, category_balance)

        # frame packing (encoder.c:157-216): 16-bit accumulator over the
        # envelope codes then the per-region mlt words
        n_regions = info["number_of_regions"]
        bits_per_frame = info["bits_per_frame"]
        out_words = []
        bits_left = 16 - info["sample_rate_bits"]
        out_word = info["sample_rate_code"] << (16 - info["sample_rate_bits"])
        drp_num = drp_num_bits + [info["rate_control_bits"]]
        drp_code = drp_code_bits + [rate_control]
        for region in range(n_regions + 1):
            i = drp_num[region] - bits_left
            if i < 0:
                out_word += drp_code[region] << -i
                bits_left -= drp_num[region]
            else:
                out_words.append((out_word + (drp_code[region] >> i))
                                 & 0xFFFF)
                bits_left += 16 - drp_num[region]
                out_word = (drp_code[region] << bits_left) & 0xFFFF
        for region in range(n_regions):
            if 16 * len(out_words) >= bits_per_frame:
                break
            region_bit_count = region_bit_counts[region]
            cur_bits = min(region_bit_count, 32)
            cur = region_bits[region * 4] & 0xFFFFFFFF
            i = 1
            while region_bit_count > 0 and 16 * len(out_words) < bits_per_frame:
                if cur_bits < bits_left:
                    bits_left -= cur_bits
                    out_word = (out_word
                                + ((cur >> (32 - cur_bits)) << bits_left)
                                ) & 0xFFFF
                    cur_bits = 0
                else:
                    out_words.append((out_word + (cur >> (32 - bits_left)))
                                     & 0xFFFF)
                    cur_bits -= bits_left
                    cur = (cur << bits_left) & 0xFFFFFFFF
                    bits_left = 16
                    out_word = 0
                if cur_bits == 0:
                    region_bit_count -= 32
                    cur = region_bits[region * 4 + i] & 0xFFFFFFFF
                    i += 1
                    cur_bits = min(region_bit_count, 32)
        while 16 * len(out_words) < bits_per_frame:
            out_words.append(((0xFFFF >> (16 - bits_left)) + out_word)
                             & 0xFFFF)
            bits_left = 16
            out_word = 0
        # checksum over the 16-bit words (encoder.c:219-238)
        nwords = bits_per_frame // 16
        out_words[nwords - 1] &= (0xFFFF << info["checksum_bits"]) & 0xFFFF
        ck = _checksum(out_words, nwords, info["checksum_bits"])
        out_words[nwords - 1] |= ck & ((1 << info["checksum_bits"]) - 1)
        return b"".join(w.to_bytes(2, "big") for w in out_words)

    def _compute_region_powers(self, coefs, esf_adjustment, n_regions):
        """compute_region_powers (huffman.c:54-120)."""
        t = _init()
        arpi = [0] * n_regions
        for region in range(n_regions):
            p = np.float32(0.0)
            base = region * REGION_SIZE
            for i in range(REGION_SIZE):
                c = np.float32(coefs[base + i])
                p = np.float32(p + np.float32(c * c))
            p = np.float32(p * np.float32(1.0 / REGION_SIZE))
            lo_i, hi_i = 0, 64
            for _ in range(6):
                idx = (lo_i + hi_i) // 2
                if t["boundary"][idx - 1] <= p:
                    lo_i = idx
                else:
                    hi_i = idx
            arpi[region] = lo_i - 24
        for region in range(n_regions - 2, -1, -1):
            if arpi[region] < arpi[region + 1] - 11:
                arpi[region] = arpi[region + 1] - 11
        arpi[0] = min(max(arpi[0], 1 - esf_adjustment), 31 - esf_adjustment)
        drp_num = [5]
        drp_code = [arpi[0] + esf_adjustment]
        for region in range(1, n_regions):
            arpi[region] = min(max(arpi[region], -8 - esf_adjustment),
                               31 - esf_adjustment)
        num_bits = 5
        for region in range(n_regions - 1):
            idx = arpi[region + 1] - arpi[region] + 12
            if idx < 0:
                idx = 0
            arpi[region + 1] = arpi[region] + idx - 12
            drp_num.append(int(_DRP_BITS[region][idx]))
            drp_code.append(int(_DRP_CODES[region][idx]))
            num_bits += drp_num[-1]
        return drp_num, drp_code, arpi, num_bits

    def _huffman_vector(self, category, power_idx, mlts):
        """huffman_vector (huffman.c:157-216) -> (region_bits, words[4])."""
        t = _init()
        temp_value = np.float32(t["dev_inv"][power_idx]
                                * t["step_inv"][category])
        out = [0, 0, 0, 0]
        out_i = 0
        bits_available = 32
        current_word = 0
        region_bits = 0
        mb = MAX_BIN[category]
        pos = 0
        for _ in range(NUMBER_OF_VECTORS[category]):
            sign_idx = idx = non_zeroes = 0
            for _ in range(VECTOR_DIMENSION[category]):
                v = np.float32(mlts[pos])
                mx = int(np.float32(np.abs(v) * temp_value)
                         + DEAD_ZONE[category])
                if mx != 0:
                    sign_idx <<= 1
                    non_zeroes += 1
                    if v > 0:
                        sign_idx += 1
                    if mx > mb or mx < 0:
                        mx = mb
                pos += 1
                idx = idx * (mb + 1) + mx
            bits = int(_BITCOUNT[category][idx]) + non_zeroes
            code = ((int(_CODES[category][idx]) << non_zeroes)
                    + sign_idx) & 0xFFFFFFFF
            region_bits += bits
            bits_available -= bits
            if bits_available < 0:
                out[out_i] = (current_word
                              + (code >> -bits_available)) & 0xFFFFFFFF
                out_i += 1
                bits_available += 32
                current_word = (code << bits_available) & 0xFFFFFFFF
            else:
                current_word = (current_word
                                + ((code << bits_available)
                                   & 0xFFFFFFFF)) & 0xFFFFFFFF
        out[out_i] = current_word
        return region_bits, out

    def _quantize_mlt(self, n_regions, rate_control_possibilities,
                      available, coefs, arpi, power_categories,
                      category_balance):
        """quantize_mlt (huffman.c:219-285)."""
        region_bit_counts = [0] * n_regions
        region_bits = [0] * (4 * n_regions)
        mlt_bits = 0
        rate_control = 0
        for rate_control in range((rate_control_possibilities >> 1) - 1):
            power_categories[category_balance[rate_control]] += 1
        rate_control = (rate_control_possibilities >> 1) - 1

        def requant(region):
            if power_categories[region] > 6:
                region_bit_counts[region] = 0
            else:
                bits, words = self._huffman_vector(
                    power_categories[region], arpi[region],
                    coefs[region * REGION_SIZE:(region + 1) * REGION_SIZE])
                region_bit_counts[region] = bits
                region_bits[region * 4:region * 4 + 4] = words

        for region in range(n_regions):
            requant(region)
            mlt_bits += region_bit_counts[region]
        while mlt_bits < available and rate_control > 0:
            rate_control -= 1
            region = category_balance[rate_control]
            power_categories[region] -= 1
            if power_categories[region] < 0:
                power_categories[region] = 0
            mlt_bits -= region_bit_counts[region]
            requant(region)
            mlt_bits += region_bit_counts[region]
        while (mlt_bits > available
               and rate_control < rate_control_possibilities):
            region = category_balance[rate_control]
            power_categories[region] += 1
            mlt_bits -= region_bit_counts[region]
            requant(region)
            mlt_bits += region_bit_counts[region]
            rate_control += 1
        return rate_control, region_bit_counts, region_bits


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class _BitReader:
    """set_bitstream/next_bit (huffman.c:27-48): MSB-first over 16-bit
    words."""

    def __init__(self, words):
        self.words = words
        self.word_i = 0
        self.bit_idx = 0
        self.current = 0

    def next_bit(self) -> int:
        if self.bit_idx == 0:
            self.current = self.words[self.word_i]
            self.word_i += 1
            self.bit_idx = 16
        self.bit_idx -= 1
        return (self.current >> self.bit_idx) & 1


class SirenDecoder:
    """Siren7_NewDecoder/Siren7_DecodeFrame (decoder.c:24-253)."""

    def __init__(self, sample_rate: int = 16000):
        self.info = codec_info(sample_rate)
        self.context = np.zeros(160, np.float32)
        self.backup_frame = np.zeros(320, np.float32)
        self.dw = [1, 1, 1, 1]
        _init()

    def _get_dw(self) -> int:
        ret = self.dw[0] + self.dw[3]
        if ret & 0x8000:
            ret += 1
        self.dw = [self.dw[1], self.dw[2], self.dw[3], ret]
        return ret

    def decode_frame(self, data: bytes) -> np.ndarray:
        """40-byte frame -> 320 int16 samples (with transmission-error
        concealment via the backup frame, decoder.c:207-216)."""
        info = self.info
        t = _init()
        words = [int.from_bytes(data[2 * i:2 * i + 2], "big")
                 for i in range(20)]
        br = _BitReader(words)
        code = 0
        for _ in range(info["sample_rate_bits"]):
            code = (code << 1) | br.next_bit()
        if code != info["sample_rate_code"]:
            raise ValueError("siren7: sample rate code mismatch")
        n_regions = info["number_of_regions"]
        n_valid = REGION_SIZE * n_regions
        available = (info["bits_per_frame"] - info["sample_rate_bits"]
                     - info["checksum_bits"])

        # decode_envelope (huffman.c:125-156)
        arpi = [0] * n_regions
        dev = np.zeros(n_regions, np.float32)
        idx = 0
        for _ in range(5):
            idx = (idx << 1) | br.next_bit()
        envelope_bits = 5
        arpi[0] = idx - info["esf_adjustment"]
        dev[0] = t["std_dev"][arpi[0] + 24]
        for i in range(1, n_regions):
            index = 0
            while True:
                index = int(_DIFF_TREE[i - 1][index][br.next_bit()])
                envelope_bits += 1
                if index <= 0:
                    break
            arpi[i] = arpi[i - 1] - index - 12
            arpi[i] = min(max(arpi[i], -24), 39)
            dev[i] = t["std_dev"][arpi[i] + 24]
        available -= envelope_bits

        rate_control = 0
        for _ in range(info["rate_control_bits"]):
            rate_control = (rate_control << 1) | br.next_bit()
        available -= info["rate_control_bits"]

        power_categories, category_balance = categorize_regions(
            n_regions, available, arpi)
        for i in range(rate_control):
            power_categories[category_balance[i]] += 1

        coefs = np.zeros(320, np.float32)
        available = self._decode_vector(
            br, n_regions, available, dev, power_categories, coefs,
            info["scale_factor"])

        frame_error = 0
        if available > 0:
            for _ in range(available):
                if br.next_bit() == 0:
                    frame_error = 1
        elif (available < 0 and rate_control + 1
                < info["rate_control_possibilities"]):
            frame_error |= 2
        for i in range(n_regions):
            if arpi[i] > 33 or arpi[i] < -31:
                frame_error |= 4
        if info["checksum_bits"] > 0:
            nwords = info["bits_per_frame"] >> 4
            checksum = words[nwords - 1] & ((1 << info["checksum_bits"]) - 1)
            words[nwords - 1] &= ~checksum & 0xFFFF
            if checksum != _checksum(words, nwords, info["checksum_bits"]):
                frame_error |= 8

        if frame_error:
            coefs[:n_valid] = self.backup_frame[:n_valid]
            self.backup_frame[:n_valid] = 0
        else:
            self.backup_frame[:n_valid] = coefs[:n_valid]
        coefs[n_valid:] = 0

        samples, self.context = rmlt_decode(coefs, self.context, 320)
        out = np.empty(320, np.int16)
        hi = samples > 32767.0
        lo = samples <= -32768.0
        mid = np.trunc(samples).astype(np.int64)
        out[:] = np.where(hi, 32767, np.where(lo, -32768, mid)
                          ).astype(np.int16)
        return out

    def _decode_vector(self, br, n_regions, available, dev,
                       power_categories, coefs, scale_factor):
        """decode_vector (huffman.c:305-433) incl. the category 5/6/7
        noise fill driven by the dw PRNG."""
        error = False
        for region in range(n_regions):
            category = power_categories[region]
            base = region * REGION_SIZE
            if category < 7:
                tree = _DECODER_TREES[category]
                ptr = base
                for _ in range(NUMBER_OF_VECTORS[category]):
                    index = 0
                    while True:
                        if available <= 0:
                            error = True
                            break
                        index = int(tree[index + br.next_bit()])
                        available -= 1
                        if index & 1:
                            break
                    index >>= 1
                    if not error and available >= 0:
                        for _ in range(VECTOR_DIMENSION[category]):
                            v = _MLT_QUANT[category][
                                index & ((1 << _INDEX_TABLE[category]) - 1)]
                            index >>= _INDEX_TABLE[category]
                            if v != 0:
                                if br.next_bit() == 0:
                                    v = np.float32(v * -dev[region])
                                else:
                                    v = np.float32(v * dev[region])
                                available -= 1
                            coefs[ptr] = np.float32(v * scale_factor)
                            ptr += 1
                    else:
                        error = True
                        break
                if error:
                    for j in range(region + 1, n_regions):
                        power_categories[j] = 7
                    category = 7
            if category == 5:
                i = 0
                for j in range(REGION_SIZE):
                    c = coefs[base + j]
                    if c != 0:
                        i += 1
                        if abs(c) > np.float32(2.0) * dev[region]:
                            i += 3
                noise = np.float32(dev[region] * _NOISE5[i])
            elif category == 6:
                i = int(np.count_nonzero(coefs[base:base + REGION_SIZE]))
                noise = np.float32(dev[region] * _NOISE6[i])
            elif category == 7:
                noise = np.float32(dev[region] * _NOISE7)
            else:
                noise = np.float32(0)
            if category in (5, 6, 7):
                dw1 = self._get_dw()
                dw2 = self._get_dw()
                ptr = base
                for j in range(10):
                    if category == 7 or coefs[ptr] == 0:
                        coefs[ptr] = noise if (dw1 & 1) else -noise
                    ptr += 1
                    dw1 >>= 1
                    if category == 7 or coefs[ptr] == 0:
                        coefs[ptr] = noise if (dw2 & 1) else -noise
                    ptr += 1
                    dw2 >>= 1
        return -1 if error else available
