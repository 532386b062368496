"""Barcode DECODING engines for the zbar / zxing elements
(ext/zbar/gstzbar.c, ext/zxing/gstzxing.cpp).

The reference elements hand the luma plane to external scanner
libraries (libzbar / libZXing) absent from this environment.  This
module implements the scanning from spec:

- QR (ISO/IEC 18004): finder-pattern localization via the classic
  1:1:3:1:1 run-ratio scan, grid sampling from the three finder
  centers, format-info decoding by minimum Hamming distance over the
  32 valid codes, per-block Reed-Solomon error CORRECTION
  (Berlekamp-Massey + Chien + Forney over GF(256)/0x11d), and segment
  parsing (numeric / alphanumeric / byte / ECI skip).  io/qr.py's
  encoder supplies the tables and the tests' symbols;
  cv2.QRCodeDetector cross-checks agreement.
- EAN-13: scanline decode of the 95-module symbol (L/G/R digit
  patterns, the first-digit parity table, checksum verification).
- EAN-8: the 67-module variant (4 L + 4 R digits, its own checksum).

Divergences (documented): libzbar scans every symbology with
interleaved scanline state machines and reports a density-based
`quality`; here QR quality = 1 and EAN-13 quality = the number of
agreeing scanlines, and the symbology list is QR-CODE + EAN-13 + EAN-8 (the
other 1D families are absent, like the reference's untrained model
files elsewhere in this build)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from gstbad.io import qr as qrenc


# -- GF(256) Reed-Solomon decoding ------------------------------------------

_EXP = qrenc._GF_EXP
_LOG = qrenc._GF_LOG


def _gmul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _ginv(a: int) -> int:
    return int(_EXP[255 - _LOG[a]])


def rs_correct(block: bytes, n_ecc: int) -> Optional[Tuple[bytes, int]]:
    """Correct up to n_ecc//2 byte errors; returns (data, n_corrected)
    or None if uncorrectable.  block = data + ecc codewords."""
    n = len(block)
    syn = [0] * n_ecc
    for i in range(n_ecc):
        s = 0
        for b in block:
            s = _gmul(s, int(_EXP[i])) ^ b
        syn[i] = s
    if not any(syn):
        return block[:n - n_ecc], 0
    # Berlekamp-Massey
    C = [1] + [0] * n_ecc
    B = [1] + [0] * n_ecc
    L, m, b = 0, 1, 1
    for i in range(n_ecc):
        d = syn[i]
        for j in range(1, L + 1):
            d ^= _gmul(C[j], syn[i - j])
        if d == 0:
            m += 1
        elif 2 * L <= i:
            T = C[:]
            coef = _gmul(d, _ginv(b))
            for j in range(n_ecc + 1 - m):
                C[j + m] ^= _gmul(coef, B[j])
            B, L, b, m = T, i + 1 - L, d, 1
        else:
            coef = _gmul(d, _ginv(b))
            for j in range(n_ecc + 1 - m):
                C[j + m] ^= _gmul(coef, B[j])
            m += 1
    if L > n_ecc // 2:
        return None
    # Chien search: x = alpha^-i a root  =>  error at byte n-1-i
    positions = []
    for i in range(n):
        x = _ginv(int(_EXP[i % 255])) if i else 1
        v, xp = 0, 1
        for c in C[:L + 1]:
            v ^= _gmul(c, xp)
            xp = _gmul(xp, x)
        if v == 0:
            positions.append(n - 1 - i)
    if len(positions) != L:
        return None
    # error values via the syndrome Vandermonde system
    # S_i = sum_k e_k * (alpha^{p_k})^i, p_k = n-1-pos_k
    locs = [int(_EXP[(n - 1 - p) % 255]) for p in positions]
    A = [[1] * L for _ in range(L)]
    for i in range(1, L):
        for k in range(L):
            A[i][k] = _gmul(A[i - 1][k], locs[k])
    rhs = syn[:L]
    # Gaussian elimination over GF(256)
    for col in range(L):
        piv = next((r for r in range(col, L) if A[r][col]), None)
        if piv is None:
            return None
        A[col], A[piv] = A[piv], A[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = _ginv(A[col][col])
        A[col] = [_gmul(v, inv) for v in A[col]]
        rhs[col] = _gmul(rhs[col], inv)
        for r in range(L):
            if r != col and A[r][col]:
                f = A[r][col]
                A[r] = [a ^ _gmul(f, b) for a, b in zip(A[r], A[col])]
                rhs[r] ^= _gmul(f, rhs[col])
    out = bytearray(block)
    for pos, e in zip(positions, rhs):
        out[pos] ^= e
    # verify all syndromes clear
    for i in range(n_ecc):
        s = 0
        for byt in out:
            s = _gmul(s, int(_EXP[i])) ^ byt
        if s != 0:
            return None
    return bytes(out[:n - n_ecc]), L


# -- QR matrix decode -------------------------------------------------------

def _read_format(m: np.ndarray) -> Optional[Tuple[str, int]]:
    """Minimum-Hamming-distance format decode (<= 3 bit errors)."""
    size = m.shape[0]
    bits1 = 0
    copy1 = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
             (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
             (0, 8)]
    # copy1 positions listed MSB-first (bit 14 at (8,0))
    for (r, c) in copy1:
        bits1 = (bits1 << 1) | int(m[r, c])
    bits2 = 0
    for i in range(7, 15):                  # bits 14..8 down col 8
        bits2 = (bits2 << 1) | int(m[size - 15 + i, 8])
    for i in range(8):                      # bits 7..0 along row 8
        bits2 = (bits2 << 1) | int(m[8, size - 8 + i])
    best = None
    for lvl in qrenc.LEVELS:
        for mask in range(8):
            code = qrenc.format_bits(lvl, mask)
            for got in (bits1, bits2):
                d = bin(code ^ got).count("1")
                if best is None or d < best[0]:
                    best = (d, lvl, mask)
    if best is None or best[0] > 3:
        return None
    return best[1], best[2]


def decode_matrix(m: np.ndarray) -> Optional[Tuple[str, dict]]:
    """bool matrix (True = dark) -> (text, info) or None."""
    size = m.shape[0]
    if size < 21 or (size - 17) % 4:
        return None
    version = (size - 17) // 4
    fmt = _read_format(m)
    if fmt is None:
        return None
    level, mask = fmt
    func = qrenc._function_mask(version)
    grid = qrenc._mask_grid(size, mask)
    um = m ^ (grid & ~func)
    # read codeword bits in placement order
    bits = []
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if not func[r, c]:
                    bits.append(int(um[r, c]))
        upward = not upward
        col -= 2
    total = qrenc.total_codewords(version)
    codewords = bytearray()
    for i in range(total):
        b = 0
        for j in range(8):
            b = (b << 1) | bits[i * 8 + j]
        codewords.append(b)
    # de-interleave
    structure = qrenc._block_structure(version, level)
    nb = len(structure)
    max_d = max(d for d, _ in structure)
    datas = [bytearray() for _ in range(nb)]
    pos = 0
    for i in range(max_d):
        for bi, (dn, _en) in enumerate(structure):
            if i < dn:
                datas[bi].append(codewords[pos])
                pos += 1
    eccs = [bytearray() for _ in range(nb)]
    n_ecc = structure[0][1]
    for i in range(n_ecc):
        for bi in range(nb):
            eccs[bi].append(codewords[pos])
            pos += 1
    corrected = bytearray()
    n_fixed = 0
    for bi in range(nb):
        res = rs_correct(bytes(datas[bi]) + bytes(eccs[bi]), n_ecc)
        if res is None:
            return None
        corrected += res[0]
        n_fixed += res[1]
    text = _parse_segments(bytes(corrected), version)
    if text is None:
        return None
    return text, {"version": version, "level": level, "mask": mask,
                  "corrected": n_fixed}


def _parse_segments(data: bytes, version: int) -> Optional[str]:
    vclass = qrenc._version_class(version)
    counts = qrenc._COUNT_BITS[vclass]
    bits = []
    for b in data:
        for i in range(7, -1, -1):
            bits.append((b >> i) & 1)
    pos = 0

    def take(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | bits[pos]
            pos += 1
        return v

    out = []
    while pos + 4 <= len(bits):
        mode = take(4)
        if mode == 0:                        # terminator
            break
        if mode == 0b0001:                   # numeric
            n = take(counts[0])
            while n >= 3:
                out.append(f"{take(10):03d}")
                n -= 3
            if n == 2:
                out.append(f"{take(7):02d}")
            elif n == 1:
                out.append(str(take(4)))
        elif mode == 0b0010:                 # alphanumeric
            n = take(counts[1])
            while n >= 2:
                v = take(11)
                out.append(qrenc._ALNUM[v // 45] + qrenc._ALNUM[v % 45])
                n -= 2
            if n:
                out.append(qrenc._ALNUM[take(6)])
        elif mode == 0b0100:                 # byte
            n = take(counts[2])
            raw = bytes(take(8) for _ in range(n))
            out.append(raw.decode("utf-8", errors="replace"))
        elif mode == 0b0111:                 # ECI: skip designator
            take(8)
        else:
            return None
    return "".join(out)


# -- QR localization --------------------------------------------------------

def _finder_candidates(binary: np.ndarray) -> List[Tuple[float, float,
                                                         float]]:
    """1:1:3:1:1 run-ratio scan over rows, cross-checked on the
    column; returns (cy, cx, module_size) candidates."""
    h, w = binary.shape
    cands: List[Tuple[float, float, float]] = []

    def check_ratio(runs):
        total = sum(runs)
        if total < 7:
            return 0.0
        unit = total / 7.0
        maxvar = unit / 2.0
        for r, expect in zip(runs, (1, 1, 3, 1, 1)):
            if abs(r - expect * unit) > expect * maxvar:
                return 0.0
        return unit

    def cross_check(cy, cx, unit):
        # full 1:1:3:1:1 verification along the column
        col = binary[:, cx]
        if not col[cy]:
            return None
        runs = [0] * 5
        y = cy
        while y >= 0 and col[y]:
            runs[2] += 1
            y -= 1
        while y >= 0 and not col[y] and runs[1] <= 3 * unit:
            runs[1] += 1
            y -= 1
        while y >= 0 and col[y] and runs[0] <= 3 * unit:
            runs[0] += 1
            y -= 1
        y0_edge = y
        y = cy + 1
        while y < h and col[y]:
            runs[2] += 1
            y += 1
        while y < h and not col[y] and runs[3] <= 3 * unit:
            runs[3] += 1
            y += 1
        while y < h and col[y] and runs[4] <= 3 * unit:
            runs[4] += 1
            y += 1
        if check_ratio(runs) <= 0:
            return None
        return y0_edge + 1 + runs[0] + runs[1] + runs[2] / 2.0

    for y in range(0, h, max(1, int(h / 400) or 1)):
        row = binary[y]
        runs: List[int] = []
        vals: List[bool] = []
        x = 0
        while x < w:
            x2 = x + 1
            v = row[x]
            while x2 < w and row[x2] == v:
                x2 += 1
            runs.append(x2 - x)
            vals.append(bool(v))
            x = x2
        for i in range(len(runs) - 4):
            if not vals[i]:                  # must start dark
                continue
            unit = check_ratio(runs[i:i + 5])
            if unit <= 0:
                continue
            cx = sum(runs[:i]) + runs[i] + runs[i + 1] + runs[i + 2] // 2
            cyf = cross_check(y, int(cx), unit)
            if cyf is None:
                continue
            cands.append((cyf, float(cx), unit))
    # merge nearby candidates
    merged: List[List[float]] = []
    for cy, cx, unit in cands:
        for mrec in merged:
            if abs(mrec[0] / mrec[3] - cy) < 2.5 * unit \
                    and abs(mrec[1] / mrec[3] - cx) < 2.5 * unit:
                mrec[0] += cy
                mrec[1] += cx
                mrec[2] += unit
                mrec[3] += 1
                break
        else:
            merged.append([cy, cx, unit, 1])
    return [(mrec[0] / mrec[3], mrec[1] / mrec[3], mrec[2] / mrec[3])
            for mrec in merged if mrec[3] >= 2]


def locate_and_sample(gray: np.ndarray) -> List[np.ndarray]:
    """Luma plane -> list of sampled bool matrices (axis-aligned
    symbols; rotation support is the localization's documented limit)."""
    thresh = (int(gray.min()) + int(gray.max())) / 2.0
    binary = gray < thresh
    cands = _finder_candidates(binary)
    if len(cands) < 3:
        return []
    out = []
    # choose triples that form an axis-aligned right angle
    n = len(cands)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                if len({i, j, k}) < 3:
                    continue
                tl, tr, bl = cands[i], cands[j], cands[k]
                if not (abs(tl[0] - tr[0]) < 4 * tl[2]
                        and abs(tl[1] - bl[1]) < 4 * tl[2]
                        and tr[1] > tl[1] and bl[0] > tl[0]):
                    continue
                unit = (tl[2] + tr[2] + bl[2]) / 3.0
                dim = round((tr[1] - tl[1]) / unit) + 7
                if dim < 21 or (dim - 17) % 4:
                    # snap to the nearest valid dimension
                    dim = max(21, int(round((dim - 17) / 4.0)) * 4 + 17)
                mod_w = (tr[1] - tl[1]) / (dim - 7)
                mod_h = (bl[0] - tl[0]) / (dim - 7)
                x0 = tl[1] - 3.5 * mod_w
                y0 = tl[0] - 3.5 * mod_h
                ys = (y0 + (np.arange(dim) + 0.5) * mod_h).astype(int)
                xs = (x0 + (np.arange(dim) + 0.5) * mod_w).astype(int)
                if ys[0] < 0 or xs[0] < 0 or ys[-1] >= gray.shape[0] \
                        or xs[-1] >= gray.shape[1]:
                    continue
                out.append(binary[np.ix_(ys, xs)])
    return out


def scan_qr(gray: np.ndarray) -> List[Tuple[str, dict]]:
    """Full scan: localization + decode, deduplicated."""
    results = []
    seen = set()
    for m in locate_and_sample(gray):
        r = decode_matrix(m)
        if r is not None and r[0] not in seen:
            seen.add(r[0])
            results.append(r)
    return results


# -- EAN-13 -----------------------------------------------------------------

_EAN_L = ("0001101", "0011001", "0010011", "0111101", "0100011",
          "0110001", "0101111", "0111011", "0110111", "0001011")
# R = bitwise complement of L; G = mirror of R
_EAN_R = tuple(p.translate(str.maketrans("01", "10")) for p in _EAN_L)
_EAN_G = tuple(p[::-1] for p in _EAN_R)
_EAN_PARITY = ("LLLLLL", "LLGLGG", "LLGGLG", "LLGGGL", "LGLLGG",
               "LGGLLG", "LGGGLL", "LGLGLG", "LGLGGL", "LGGLGL")


def ean13_render(digits: str, module_px: int = 3,
                 height: int = 60) -> np.ndarray:
    """Reference symbol renderer for tests: 13 digits -> u8 image."""
    assert len(digits) == 13 and digits.isdigit()
    first = int(digits[0])
    parity = _EAN_PARITY[first]
    bits = "101"
    for i, d in enumerate(digits[1:7]):
        pat = _EAN_L[int(d)] if parity[i] == "L" else _EAN_G[int(d)]
        bits += pat
    bits += "01010"
    for d in digits[7:]:
        bits += _EAN_R[int(d)]
    bits += "101"
    row = np.array([c == "1" for c in bits])
    img = np.where(np.repeat(row, module_px), 0, 255).astype(np.uint8)
    img = np.tile(img[None, :], (height, 1))
    pad = 9 * module_px
    return np.pad(img, ((pad, pad), (pad, pad)), constant_values=255)


def ean13_checksum_ok(digits: str) -> bool:
    s = sum(int(d) * (3 if i % 2 else 1)
            for i, d in enumerate(digits[:12]))
    return (10 - s % 10) % 10 == int(digits[12])


def _decode_ean13_runs(widths: List[float]) -> Optional[str]:
    """59 run widths (start guard first) -> 13 digits or None."""
    if len(widths) != 59:
        return None
    unit = sum(widths) / 95.0
    if not _guards_ok(widths, unit, 27):
        return None

    def match(pats, runs, dark_first):
        best, besterr = None, None
        for di, pat in enumerate(pats):
            # pattern -> run lengths
            prun = []
            cur = pat[0]
            cnt = 0
            for ch in pat:
                if ch == cur:
                    cnt += 1
                else:
                    prun.append(cnt)
                    cur = ch
                    cnt = 1
            prun.append(cnt)
            if pat[0] != ("1" if dark_first else "0") or len(prun) != 4:
                continue
            err = sum(abs(r - p * unit) for r, p in zip(runs, prun))
            if besterr is None or err < besterr:
                best, besterr = di, err
        if best is None or besterr > 3.5 * unit:
            return None
        return best

    # guards: 101 (3 runs), digits 6*4 runs, 01010 (5 runs, starts
    # light), 6*4 runs, 101
    pos = 3
    left = []
    parity = ""
    for _ in range(6):
        runs = widths[pos:pos + 4]
        dl = match(_EAN_L, runs, dark_first=False)
        dg = match(_EAN_G, runs, dark_first=False)
        # L patterns start with 0 (light); runs alternate starting light
        if dl is not None and dg is not None:
            # pick the better fit
            dl_pat, dg_pat = _EAN_L[dl], _EAN_G[dg]

            def err_of(pat):
                prun = []
                cur, cnt = pat[0], 0
                for ch in pat:
                    if ch == cur:
                        cnt += 1
                    else:
                        prun.append(cnt)
                        cur, cnt = ch, 1
                prun.append(cnt)
                return sum(abs(r - p * unit)
                           for r, p in zip(runs, prun))
            if err_of(dl_pat) <= err_of(dg_pat):
                dg = None
            else:
                dl = None
        if dl is not None:
            left.append(dl)
            parity += "L"
        elif dg is not None:
            left.append(dg)
            parity += "G"
        else:
            return None
        pos += 4
    pos += 5                                  # middle guard
    right = []
    for _ in range(6):
        d = match(_EAN_R, widths[pos:pos + 4], dark_first=True)
        if d is None:
            return None
        right.append(d)
        pos += 4
    if parity not in _EAN_PARITY:
        return None
    first = _EAN_PARITY.index(parity)
    digits = str(first) + "".join(map(str, left)) \
        + "".join(map(str, right))
    if not ean13_checksum_ok(digits):
        return None
    return digits


def scan_ean13(gray: np.ndarray) -> Optional[Tuple[str, int]]:
    """Scanline sweep; returns (digits, n_agreeing_lines) or None."""
    h, w = gray.shape
    thresh = (int(gray.min()) + int(gray.max())) / 2.0
    votes = {}
    for y in range(0, h, max(1, h // 32)):
        row = gray[y] < thresh
        # run-length encode
        runs: List[int] = []
        vals: List[bool] = []
        x = 0
        while x < w:
            x2 = x + 1
            v = row[x]
            while x2 < w and row[x2] == v:
                x2 += 1
            runs.append(x2 - x)
            vals.append(bool(v))
            x = x2
        # try every dark run as the start guard
        for i in range(len(runs) - 58):
            if not vals[i]:
                continue
            digits = _decode_ean13_runs(
                [float(r) for r in runs[i:i + 59]])
            if digits:
                votes[digits] = votes.get(digits, 0) + 1
    if not votes:
        return None
    best = max(votes.items(), key=lambda kv: kv[1])
    return best


# -- EAN-8 ------------------------------------------------------------------

def ean8_checksum_ok(digits: str) -> bool:
    s = sum(int(d) * (3 if i % 2 == 0 else 1)
            for i, d in enumerate(digits[:7]))
    return (10 - s % 10) % 10 == int(digits[7])


def ean8_render(digits: str, module_px: int = 3,
                height: int = 50) -> np.ndarray:
    """Reference renderer for tests: 8 digits -> u8 image (67-module
    symbol: guard 101, 4 L digits, 01010, 4 R digits, 101)."""
    assert len(digits) == 8 and digits.isdigit()
    bits = "101"
    for d in digits[:4]:
        bits += _EAN_L[int(d)]
    bits += "01010"
    for d in digits[4:]:
        bits += _EAN_R[int(d)]
    bits += "101"
    row = np.array([c == "1" for c in bits])
    img = np.where(np.repeat(row, module_px), 0, 255).astype(np.uint8)
    img = np.tile(img[None, :], (height, 1))
    pad = 9 * module_px
    return np.pad(img, ((pad, pad), (pad, pad)), constant_values=255)


def _guards_ok(widths: List[float], unit: float,
               mid_start: int) -> bool:
    """Start/middle/end guards must be single-module runs."""
    idx = list(range(3)) + list(range(mid_start, mid_start + 5)) \
        + list(range(len(widths) - 3, len(widths)))
    return all(abs(widths[i] - unit) <= 0.6 * unit for i in idx)


def _decode_ean8_runs(widths: List[float]) -> Optional[str]:
    """43 run widths -> 8 digits or None."""
    if len(widths) != 43:
        return None
    unit = sum(widths) / 67.0
    if not _guards_ok(widths, unit, 19):
        return None

    def match(pats, runs, dark_first):
        best, besterr = None, None
        for di, pat in enumerate(pats):
            prun = []
            cur, cnt = pat[0], 0
            for ch in pat:
                if ch == cur:
                    cnt += 1
                else:
                    prun.append(cnt)
                    cur, cnt = ch, 1
            prun.append(cnt)
            if pat[0] != ("1" if dark_first else "0") or len(prun) != 4:
                continue
            err = sum(abs(r - p * unit) for r, p in zip(runs, prun))
            if besterr is None or err < besterr:
                best, besterr = di, err
        if best is None or besterr > 3.5 * unit:
            return None
        return best

    pos = 3
    left = []
    for _ in range(4):
        d = match(_EAN_L, widths[pos:pos + 4], dark_first=False)
        if d is None:
            return None
        left.append(d)
        pos += 4
    pos += 5
    right = []
    for _ in range(4):
        d = match(_EAN_R, widths[pos:pos + 4], dark_first=True)
        if d is None:
            return None
        right.append(d)
        pos += 4
    digits = "".join(map(str, left + right))
    if not ean8_checksum_ok(digits):
        return None
    return digits


def scan_ean8(gray: np.ndarray) -> Optional[Tuple[str, int]]:
    """Scanline sweep like scan_ean13 but for the 67-module symbol."""
    h, w = gray.shape
    thresh = (int(gray.min()) + int(gray.max())) / 2.0
    votes = {}
    for y in range(0, h, max(1, h // 32)):
        row = gray[y] < thresh
        runs: List[int] = []
        vals: List[bool] = []
        x = 0
        while x < w:
            x2 = x + 1
            v = row[x]
            while x2 < w and row[x2] == v:
                x2 += 1
            runs.append(x2 - x)
            vals.append(bool(v))
            x = x2
        for i in range(len(runs) - 42):
            if not vals[i]:
                continue
            digits = _decode_ean8_runs([float(r)
                                        for r in runs[i:i + 43]])
            if digits:
                votes[digits] = votes.get(digits, 0) + 1
    if not votes:
        return None
    return max(votes.items(), key=lambda kv: kv[1])
