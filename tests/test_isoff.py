"""ISO BMFF box parsing (gst-libs/gst/isoff) — transcription of the
upstream unit test (tests/check/libs/isoff.c) over the same canned
vectors (tests/data/isoff/, see the provenance README)."""

import json
import pathlib
import struct

import pytest

from gstbad.io import isoff

DATA = pathlib.Path(__file__).parent / "data" / "isoff"
CONSTS = json.loads((DATA / "constants.json").read_text())


def _vec(name):
    return (DATA / f"{name}.bin").read_bytes()


# -------------------------------------------------- box header parsing

def test_box_header_minimal():
    """isoff.c isoff_box_header_minimal."""
    data = bytes([0x10, 0x20, 0x40, 0x80]) + b"test"
    fourcc, ext, hsize, size = isoff.parse_box_header(
        isoff.ByteReader(data))
    assert fourcc == b"test"
    assert hsize == 8
    assert size == 0x10204080


def test_box_header_long_size():
    data = bytes([0, 0, 0, 1]) + b"test" \
        + bytes([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80])
    fourcc, ext, hsize, size = isoff.parse_box_header(
        isoff.ByteReader(data))
    assert fourcc == b"test"
    assert hsize == 16
    assert size == 0x0102040810204080


def test_box_header_uuid_type():
    uuid = bytes(range(16))
    data = bytes([0x10, 0x20, 0x40, 0x80]) + b"uuid" + uuid
    fourcc, ext, hsize, size = isoff.parse_box_header(
        isoff.ByteReader(data))
    assert fourcc == b"uuid"
    assert hsize == 24
    assert size == 0x10204080
    assert ext == uuid


def test_box_header_uuid_type_long_size():
    uuid = bytes(range(16))
    data = bytes([0, 0, 0, 1]) + b"uuid" \
        + bytes([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80]) + uuid
    fourcc, ext, hsize, size = isoff.parse_box_header(
        isoff.ByteReader(data))
    assert fourcc == b"uuid"
    assert hsize == 32
    assert size == 0x0102040810204080
    assert ext == uuid


def test_box_header_needs_more_data():
    assert isoff.parse_box_header(isoff.ByteReader(b"\x00\x00")) is None
    r = isoff.ByteReader(bytes([0, 0, 0, 1]) + b"test")
    assert isoff.parse_box_header(r) is None
    assert r.pos == 0  # position restored


# --------------------------------------------------------------- moof

def test_moof_parse():
    """isoff.c isoff_moof_parse over moof1."""
    data = _vec("moof1")
    r = isoff.ByteReader(data)
    fourcc, _, hsize, size = isoff.parse_box_header(r)
    assert fourcc == b"moof" and hsize == 8 and size == len(data)
    moof = isoff.parse_moof(data[8:])
    assert moof is not None
    assert moof.mfhd.sequence_number == 1
    assert len(moof.traf) == 1
    traf = moof.traf[0]
    assert traf.tfhd.version == 0
    assert traf.tfhd.flags == \
        isoff.TFHD_DEFAULT_SAMPLE_DURATION_PRESENT
    assert traf.tfhd.track_id == 1
    assert traf.tfhd.base_data_offset == 0
    assert traf.tfhd.sample_description_index == 0
    assert traf.tfhd.default_sample_duration == 8
    assert traf.tfhd.default_sample_size == 0
    assert traf.tfhd.default_sample_flags == 0
    assert len(traf.trun) == 1
    trun = traf.trun[0]
    assert trun.version == 1
    assert trun.flags == (isoff.TRUN_SAMPLE_SIZE_PRESENT
                          | isoff.TRUN_SAMPLE_FLAGS_PRESENT
                          | isoff.TRUN_SAMPLE_COMPOSITION_TIME_OFFSETS_PRESENT
                          | isoff.TRUN_DATA_OFFSET_PRESENT)
    assert trun.sample_count == 96
    assert trun.data_offset == len(data) + 8
    assert trun.first_sample_flags == 0
    assert len(trun.samples) == 96
    for i, sample in enumerate(trun.samples):
        assert sample.sample_duration == 0
        if i == 0:
            assert sample.sample_flags == 0x02000000  # I-frame
        else:
            assert sample.sample_flags == 0x01010000


def test_moof_parse_with_tfdt():
    """isoff.c isoff_moof_parse_with_tfdt over seg_2_m4f."""
    data = _vec("seg_2_m4f")
    r = isoff.ByteReader(data)
    fourcc, _, hsize, size = isoff.parse_box_header(r)
    assert fourcc == b"moof"
    moof = isoff.parse_moof(data[hsize:size])
    assert moof is not None
    assert moof.mfhd.sequence_number == 4
    traf = moof.traf[0]
    assert traf.tfhd.flags == isoff.TFHD_DEFAULT_BASE_IS_MOOF
    assert traf.tfhd.track_id == 2
    assert traf.tfdt.decode_time == 132096
    trun = traf.trun[0]
    assert trun.version == 0
    assert trun.flags == (isoff.TRUN_SAMPLE_SIZE_PRESENT
                          | isoff.TRUN_SAMPLE_DURATION_PRESENT
                          | isoff.TRUN_DATA_OFFSET_PRESENT)
    assert trun.sample_count == 129
    assert trun.data_offset == size + hsize
    assert len(trun.samples) == 129
    for i, sample in enumerate(trun.samples):
        assert sample.sample_duration == CONSTS["seg_sample_duration"]
        assert sample.sample_flags == 0
        assert sample.sample_size == CONSTS["seg_2_sample_sizes"][i]


def test_moof_parse_with_tfxd_tfrf():
    """isoff.c isoff_moof_parse_with_tfxd_tfrf over the MSS audio
    fragment."""
    data = _vec("Fragments_audio")
    r = isoff.ByteReader(data)
    fourcc, _, hsize, size = isoff.parse_box_header(r)
    assert fourcc == b"moof" and size == len(data)
    moof = isoff.parse_moof(data[8:])
    assert moof is not None
    assert moof.mfhd.sequence_number == 124
    traf = moof.traf[0]
    assert traf.tfhd.track_id == 1
    assert traf.tfxd is not None
    assert traf.tfxd.time == 1188108174758706
    assert traf.tfxd.duration == 19969161
    assert traf.tfrf is not None
    assert len(traf.tfrf.entries) == 2
    assert traf.tfrf.entries[0].time == 1188108194727867
    assert traf.tfrf.entries[0].duration == 19969160
    assert traf.tfrf.entries[1].time == 1188108214697027
    assert traf.tfrf.entries[1].duration == 19969162


def test_moof_requires_mfhd_and_tfhd():
    # traf without tfhd
    tfdt = struct.pack(">I", 16) + b"tfdt" + b"\x00\x00\x00\x00" \
        + struct.pack(">I", 42)
    traf = struct.pack(">I", 8 + len(tfdt)) + b"traf" + tfdt
    mfhd = struct.pack(">I", 16) + b"mfhd" + b"\x00\x00\x00\x00" \
        + struct.pack(">I", 1)
    assert isoff.parse_moof(mfhd + traf) is None
    # moof without mfhd
    tfhd = struct.pack(">I", 16) + b"tfhd" + b"\x00\x00\x00\x00" \
        + struct.pack(">I", 1)
    traf = struct.pack(">I", 8 + len(tfhd)) + b"traf" + tfhd
    assert isoff.parse_moof(traf) is None
    # and a valid minimal one parses
    assert isoff.parse_moof(mfhd + traf) is not None


def test_mfhd_requires_exact_payload():
    """gstisoff.c:148: mfhd payload must be exactly 8 bytes."""
    mfhd_long = struct.pack(">I", 20) + b"mfhd" + b"\x00" * 12
    assert isoff.parse_moof(mfhd_long) is None


# --------------------------------------------------------------- moov

def test_moov_parse():
    """isoff.c isoff_moov_parse over init_mp4."""
    data = _vec("init_mp4")
    r = isoff.ByteReader(data)
    fourcc, _, hsize, size = isoff.parse_box_header(r)
    assert fourcc == b"moov" and size == len(data)
    moov = isoff.parse_moov(data[8:])
    assert moov is not None
    assert len(moov.trak) == 1
    trak = moov.trak[0]
    assert trak.tkhd.track_id == 2
    assert trak.mdia.hdlr.handler_type == b"soun"
    assert trak.mdia.mdhd.timescale == CONSTS["seg_timescale"]


# --------------------------------------------------------------- sidx

def _sidx_payload(version=0, timescale=1000, earliest=0, first_off=0,
                  entries=()):
    out = bytes([version]) + b"\x00\x00\x00"
    out += struct.pack(">II", 1, timescale)
    if version == 0:
        out += struct.pack(">II", earliest, first_off)
    else:
        out += struct.pack(">QQ", earliest, first_off)
    out += struct.pack(">HH", 0, len(entries))
    for ref_type, size, dur, sap in entries:
        out += struct.pack(">III", (ref_type << 31) | size, dur, sap)
    return out


def test_sidx_parse():
    p = isoff.SidxParser()
    payload = _sidx_payload(timescale=1000, earliest=500,
                            entries=[(0, 100, 1000, 1 << 31),
                                     (0, 200, 2000, 0)])
    p.parse(payload)
    assert p.status == p.FINISHED
    assert p.timescale == 1000
    assert p.earliest_pts == 500
    assert len(p.entries) == 2
    e0, e1 = p.entries
    assert e0.offset == 0 and e0.size == 100
    assert e0.pts == 500_000_000          # scaled to ns
    assert e0.duration == 1_000_000_000
    assert e0.starts_with_sap == 1
    assert e1.offset == 100
    assert e1.pts == 1_500_000_000
    assert e1.duration == 2_000_000_000


def test_sidx_parse_incremental():
    """The upstream parser is resumable at any byte boundary."""
    payload = _sidx_payload(version=1, timescale=90000, earliest=90000,
                            entries=[(1, 5000, 45000, 0),
                                     (0, 6000, 90000, 0),
                                     (0, 7000, 45000, 0)])
    p = isoff.SidxParser()
    for i in range(0, len(payload), 5):
        p.parse(payload[i:i + 5])
    assert p.status == p.FINISHED
    assert p.earliest_pts == 90000
    assert [e.size for e in p.entries] == [5000, 6000, 7000]
    assert [e.ref_type for e in p.entries] == [1, 0, 0]
    assert p.entries[1].pts == 1_500_000_000
    assert p.entries[2].offset == 11000


def test_sidx_flags_little_endian_quirk():
    """gstisoff.c:844 reads the sidx flags 24-bit LITTLE-endian."""
    payload = _sidx_payload()
    payload = payload[:1] + b"\x01\x02\x03" + payload[4:]
    p = isoff.SidxParser()
    p.parse(payload)
    assert p.flags == 0x030201
