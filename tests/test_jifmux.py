"""jifmux / jpegparse (gst/jpegformat) — EXIF/XMP tag injection.

The upstream test (tests/check/elements/jifmux.c:1029-1095) builds a
taglist, muxes it into a JPEG, then VERIFIES by re-parsing the produced
EXIF with the real libexif and comparing per-tag values; these tests
use the same libexif through the io/exif ctypes binding and the same
tag values (jifmux.c:1044-1070)."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import exif as ex
from gstbad.io import xmp as xmp_io
from gstbad.io.jpeg import JpegParse, jif_mux

cv2 = pytest.importorskip("cv2")

need_libexif = pytest.mark.skipif(not ex.libexif_available(),
                                  reason="libexif not available")

# the exact upstream taglist (jifmux.c:1044-1070)
UPSTREAM_TAGS = {
    "artist": "some artist",
    "copyright": "My copyright notice",
    "device-manufacturer": "MyFavoriteBrand",
    "device-model": "123v42.1",
    "description": "some description",
    "application-name": "jifmux-test v1.2b",
    "capturing-shutter-speed": (1, 30),
    "capturing-focal-ratio": 2.0,
    "capturing-iso-speed": 800,
    "datetime": "2000:10:05 08:45:13",
    "capturing-focal-length": 22.5,
    "capturing-digital-zoom-ratio": 5.25,
    "capturing-exposure-compensation": -2.5,
    "application-data": b"some data",
    "capturing-flash-fired": True,
    "capturing-flash-mode": "auto",
    "capturing-source": "dsc",
    "capturing-metering-mode": "multi-spot",
    "capturing-sharpness": "normal",
    "capturing-saturation": "normal",
    "capturing-contrast": "normal",
    "geo-location-latitude": -32.375,
    "geo-location-longitude": 76.0125,
    "geo-location-elevation": 300.85,
    "geo-location-movement-speed": 3.6,
    "geo-location-movement-direction": 35.4,
    "geo-location-capture-direction": 12.345,
    "image-horizontal-ppi": 300.0,
    "image-vertical-ppi": 96.0,
}


def _jpeg(w=32, h=24):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def _markers(jpeg):
    """[(marker, payload)] up to and including SOS."""
    out = []
    pos = 0
    while pos + 1 < len(jpeg):
        assert jpeg[pos] == 0xFF
        m = jpeg[pos + 1]
        if m in (0xD8, 0xD9):
            out.append((m, b""))
            pos += 2
            continue
        ln = struct.unpack_from(">H", jpeg, pos + 2)[0]
        out.append((m, jpeg[pos + 4:pos + 2 + ln]))
        if m == 0xDA:
            return out
        pos += 2 + ln
    return out


# ------------------------------------------------------------- libexif

@need_libexif
def test_exif_upstream_taglist_via_libexif():
    """Every tag from the upstream taglist survives a libexif re-parse
    with the value the upstream compare_* callbacks check for."""
    blob = ex.build_exif(UPSTREAM_TAGS)
    I0, IE, IG = ex.IFD0, ex.IFD_EXIF, ex.IFD_GPS
    got = ex.read_exif_raw(blob, [
        (I0, 0x010E), (I0, 0x010F), (I0, 0x0110), (I0, 0x011A),
        (I0, 0x011B), (I0, 0x0128), (I0, 0x0131), (I0, 0x0132),
        (I0, 0x013B), (I0, 0x8298),
        (IE, 0x829A), (IE, 0x829D), (IE, 0x8827), (IE, 0x9003),
        (IE, 0x9201), (IE, 0x9202), (IE, 0x9204), (IE, 0x9207),
        (IE, 0x9209), (IE, 0x920A), (IE, 0x927C), (IE, 0xA300),
        (IE, 0xA404), (IE, 0xA408), (IE, 0xA409), (IE, 0xA40A),
        (IG, 1), (IG, 2), (IG, 3), (IG, 4), (IG, 5), (IG, 6),
        (IG, 12), (IG, 13), (IG, 14), (IG, 15), (IG, 16), (IG, 17),
    ])
    assert got[(I0, 0x010E)] == "some description"
    assert got[(I0, 0x010F)] == "MyFavoriteBrand"
    assert got[(I0, 0x0110)] == "123v42.1"
    assert got[(I0, 0x011A)] == (300, 1)
    assert got[(I0, 0x011B)] == (96, 1)
    assert got[(I0, 0x0128)] == 2  # inches
    assert got[(I0, 0x0131)] == "jifmux-test v1.2b"
    assert got[(I0, 0x0132)] == "2000:10:05 08:45:13"
    assert got[(I0, 0x013B)] == "some artist"
    assert got[(I0, 0x8298)] == "My copyright notice"

    assert got[(IE, 0x829A)] == (1, 30)          # exposure time
    n, d = got[(IE, 0x829D)]                     # fnumber
    assert n / d == 2.0
    assert got[(IE, 0x8827)] == 800              # ISO
    assert got[(IE, 0x9003)] == "2000:10:05 08:45:13"
    n, d = got[(IE, 0x9201)]                     # APEX shutter
    assert abs(2 ** -(n / d) - 1 / 30) < 0.001   # compare_shutter_speed
    n, d = got[(IE, 0x9202)]                     # APEX aperture
    assert abs(2 ** (n / d / 2) - 2.0) < 0.001   # compare_aperture_value
    n, d = got[(IE, 0x9204)]                     # exposure bias
    assert n / d == -2.5
    assert got[(IE, 0x9207)] == 4                # multi-spot
    flash = got[(IE, 0x9209)]
    assert flash & 1                             # fired (compare_flash)
    assert flash & 0x18 == 0x18                  # mode auto
    n, d = got[(IE, 0x920A)]
    assert n / d == 22.5                         # focal length
    assert got[(IE, 0x927C)] == b"some data"     # maker note
    assert got[(IE, 0xA300)] == b"\x03"          # file source dsc
    n, d = got[(IE, 0xA404)]
    assert n / d == 5.25                         # digital zoom
    assert got[(IE, 0xA408)] == 0                # contrast normal
    assert got[(IE, 0xA409)] == 0                # saturation normal
    assert got[(IE, 0xA40A)] == 0                # sharpness normal

    assert got[(IG, 1)] == "S"
    (dg, _), (mn, _), (sn, sd) = got[(IG, 2)]
    assert -(dg + mn / 60 + sn / sd / 3600) == pytest.approx(-32.375)
    assert got[(IG, 3)] == "E"
    (dg, _), (mn, _), (sn, sd) = got[(IG, 4)]
    assert dg + mn / 60 + sn / sd / 3600 == pytest.approx(76.0125)
    assert got[(IG, 5)] == b"\x00"               # above sea level
    n, d = got[(IG, 6)]
    assert n / d == pytest.approx(300.85)
    assert got[(IG, 12)] == "K"                  # km/h
    n, d = got[(IG, 13)]
    assert n / d == pytest.approx(3.6 * 3.6)     # m/s -> km/h
    assert got[(IG, 14)] == "T"
    n, d = got[(IG, 15)]
    assert n / d == pytest.approx(35.4)
    assert got[(IG, 16)] == "T"
    n, d = got[(IG, 17)]
    assert n / d == pytest.approx(12.345)


@need_libexif
@pytest.mark.parametrize("name,value", sorted(ex.ORIENTATIONS.items()))
def test_exif_orientation_sweep(name, value):
    """jifmux.c:1077-1098 runs all 8 orientations through libexif."""
    blob = ex.build_exif({"image-orientation": name})
    got = ex.read_exif_raw(blob, [(ex.IFD0, 0x0112)])
    assert got[(ex.IFD0, 0x0112)] == value


@need_libexif
@pytest.mark.parametrize("key,tag,table", [
    ("capturing-exposure-program", 0x8822, ex.EXPOSURE_PROGRAMS),
    ("capturing-exposure-mode", 0xA402, ex.EXPOSURE_MODES),
    ("capturing-scene-capture-type", 0xA406, ex.SCENE_TYPES),
    ("capturing-white-balance", 0xA403, ex.WHITE_BALANCES),
    ("capturing-gain-adjustment", 0xA407, ex.GAIN_LEVELS),
    ("capturing-metering-mode", 0x9207, ex.METERING_MODES),
])
def test_exif_enum_sweeps(key, tag, table):
    """jifmux.c:1100-1220 sweeps every enum string of each tag."""
    for name, value in table.items():
        blob = ex.build_exif({key: name})
        got = ex.read_exif_raw(blob, [(ex.IFD_EXIF, tag)])
        assert got[(ex.IFD_EXIF, tag)] == value, name


@need_libexif
def test_exif_rendered_values():
    """exif_entry_get_value smoke: libexif renders readable strings."""
    blob = ex.build_exif(UPSTREAM_TAGS)
    got = ex.read_exif(blob, [(ex.IFD0, 0x013B), (ex.IFD_EXIF, 0x829A)])
    assert got[(ex.IFD0, 0x013B)] == "some artist"
    assert "1/30" in got[(ex.IFD_EXIF, 0x829A)]


# ----------------------------------------------------------------- xmp

def test_xmp_roundtrip():
    tags = {"artist": "some artist", "copyright": "My copyright notice",
            "description": "a <desc> & more", "device-model": "123v42.1",
            "device-manufacturer": "MyFavoriteBrand",
            "application-name": "jifmux-test v1.2b",
            "image-orientation": "rotate-90",
            "keywords": ["alpha", "beta"],
            "datetime": "2000:10:05 08:45:13",
            "geo-location-latitude": -32.375,
            "geo-location-longitude": 76.0125}
    blob = xmp_io.build_xmp(tags)
    assert blob.startswith(b"<?xpacket begin=")
    got = xmp_io.parse_xmp(blob)
    for k, v in tags.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v)
        else:
            assert got[k] == v


# ------------------------------------------------------------- element

def test_jifmux_element_marker_order():
    """gstjifmux.c:378-383 ordering: APP0 JFIF, Exif APP1, XMP APP1,
    COM, then the frame headers."""
    mux = gt.make("jifmux")
    mux.set_tags(**UPSTREAM_TAGS)
    out = mux.chain(_jpeg())
    ms = _markers(out)
    kinds = [m for m, _ in ms]
    assert kinds[0] == 0xD8
    i_app0 = kinds.index(0xE0)
    app1s = [i for i, (m, p) in enumerate(ms) if m == 0xE1]
    i_com = kinds.index(0xFE)
    assert ms[i_app0][1][:5] == b"JFIF\x00"
    assert ms[app1s[0]][1][:6] == b"Exif\x00\x00"
    assert ms[app1s[1]][1][:29] == xmp_io.XMP_HEADER
    assert i_app0 < app1s[0] < app1s[1] < i_com < kinds.index(0xDA)
    # COM falls back to description (no comment/title set)
    assert ms[i_com][1] == b"some description\x00"
    # still a decodable JPEG
    img = cv2.imdecode(np.frombuffer(out, np.uint8), cv2.IMREAD_COLOR)
    assert img is not None and img.shape == (24, 32, 3)


@need_libexif
def test_jifmux_element_exif_via_libexif():
    mux = gt.make("jifmux")
    mux.set_tags(**UPSTREAM_TAGS)
    out = mux.chain(_jpeg())
    exif_payload = next(p for m, p in _markers(out)
                        if m == 0xE1 and p[:4] == b"Exif")
    got = ex.read_exif_raw(exif_payload, [(ex.IFD0, 0x013B),
                                          (ex.IFD_EXIF, 0x8827)])
    assert got[(ex.IFD0, 0x013B)] == "some artist"
    assert got[(ex.IFD_EXIF, 0x8827)] == 800


def test_jifmux_replaces_existing_app1():
    """Remuxing an already-tagged JPEG replaces the Exif/XMP APP1s
    instead of stacking a second copy (gstjifmux.c:544-547,582-586)."""
    mux = gt.make("jifmux")
    mux.set_tags(artist="first")
    once = mux.chain(_jpeg())
    mux2 = gt.make("jifmux")
    mux2.set_tags(artist="second")
    twice = mux2.chain(once)
    app1s = [p for m, p in _markers(twice) if m == 0xE1]
    assert len(app1s) == 2  # one Exif + one XMP
    assert sum(1 for p in app1s if p[:4] == b"Exif") == 1
    if ex.libexif_available():
        got = ex.read_exif_raw(app1s[0], [(ex.IFD0, 0x013B)])
        assert got[(ex.IFD0, 0x013B)] == "second"


def test_jifmux_no_tags_passthrough_structure():
    """With no tags, the remux only normalizes marker order (the
    synthesized JFIF APP0) — scan data is untouched byte-exact."""
    src = _jpeg()
    out = gt.make("jifmux").chain(src)
    sos_src = src[src.find(b"\xff\xda"):]
    sos_out = out[out.find(b"\xff\xda"):]
    assert sos_src == sos_out
    img = cv2.imdecode(np.frombuffer(out, np.uint8), cv2.IMREAD_COLOR)
    assert img is not None


def test_jif_mux_rejects_non_jpeg():
    with pytest.raises(ValueError):
        jif_mux(b"not a jpeg")


# ----------------------------------------------------------- jpegparse

def test_jpegparse_element_frames_and_caps():
    j1, j2 = _jpeg(32, 24), _jpeg(64, 48)
    stream = j1 + j2
    parse = gt.make("jpegparse")
    outs = []
    for i in range(0, len(stream), 333):
        outs += parse.chain(stream[i:i + 333])
    assert [o["data"] for o in outs] == [j1, j2]
    assert outs[0]["caps"]["width"] == 32
    assert outs[0]["caps"]["height"] == 24
    assert outs[1]["caps"]["width"] == 64
    assert outs[1]["caps"]["height"] == 48


def test_jpegparse_resyncs_over_garbage():
    j = _jpeg()
    p = JpegParse()
    out = p.push(b"\x00\x01garbage\xff" + j + b"\xde\xad" + j)
    assert [i.data for i in out] == [j, j]
