"""Robustness sweep: every byte-domain parser must survive garbage,
truncations and random mutations of valid streams — raising only its
documented error type, never IndexError/struct.error/KeyError, and
never hanging."""

import json
import os

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import asf, av1obu, gdp, h263, h264, h265nal
from gstbad.io import kate as kate_io
from gstbad.io import m3u8, mpegps, mpegts, mxf, dashmpd
from gstbad.io import uvch264, vp9

DATA = os.path.dirname(__file__) + "/data"

OK_ERRORS = (ValueError,)  # every io error type derives from ValueError


@pytest.fixture
def rng():
    return np.random.default_rng(99)


def _mutations(rng, blob: bytes, n=40):
    yield b""
    yield blob[: len(blob) // 3]
    yield blob[len(blob) // 3:]
    for _ in range(n):
        b = bytearray(blob)
        for _ in range(rng.integers(1, 8)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        yield bytes(b)
    yield bytes(rng.integers(0, 256, 512, np.uint8))


def test_fuzz_mpegts(rng):
    mux = mpegts.TsMux()
    v = mux.add_stream(mpegts.ST_VIDEO_H264)
    stream = b"".join(mux.add_data(v, bytes(rng.integers(0, 256, 500,
                                                         np.uint8)),
                                   pts=90000))
    for blob in _mutations(rng, stream):
        d = mpegts.TsDemux()
        try:
            d.push(blob)
            d.eos()
        except OK_ERRORS:
            pass


def test_fuzz_mpegps(rng):
    mux = mpegps.PsMux()
    v = mux.add_stream(mpegps.ST_VIDEO_MPEG2)
    stream = mux.add_data(v, bytes(rng.integers(0, 256, 500, np.uint8)),
                          pts=90000) + mux.finish()
    for blob in _mutations(rng, stream):
        d = mpegps.PsDemux()
        try:
            d.push(blob)
        except OK_ERRORS:
            pass


def test_fuzz_asf(rng):
    mux = asf.AsfMux(ecc=True)
    a = mux.add_audio_stream(0x50, 2, 48000)
    stream = mux.header() + mux.add_buffer(
        a, bytes(rng.integers(0, 256, 400, np.uint8)), 0) + mux.finish()
    for blob in _mutations(rng, stream):
        p = asf.AsfParse()
        try:
            p.push(blob)
        except OK_ERRORS:
            pass


def test_fuzz_mxf(rng):
    mux = mxf.MxfMux(width=32, height=32, channels=1)
    mux.add_video(b"v" * 64)
    mux.add_audio(b"a" * 64)
    stream = mux.finish()
    for blob in _mutations(rng, stream):
        d = mxf.MxfDemux()
        try:
            d.push(blob)
        except OK_ERRORS:
            pass


def test_fuzz_kate(rng):
    enc = kate_io.KateEncoder(kate_io.KateInfo(category="SUB"))
    pkts = enc.encode_headers() + [enc.encode_text(0, 1, b"hi")]
    for pkt in pkts:
        for blob in _mutations(rng, pkt, n=15):
            dec = kate_io.KateDecoder()
            try:
                for h in pkts[:2]:
                    dec.packetin(h)
                dec.packetin(blob)
            except OK_ERRORS:
                pass


def test_fuzz_h264parse(rng):
    from tests.test_h264parse import STREAM
    for blob in _mutations(rng, STREAM):
        el = gt.make("h264parse")
        try:
            el.push(blob)
            el.finish()
        except OK_ERRORS:
            pass


def test_fuzz_h265parse(rng):
    from tests.test_h265parse import STREAM16, H265_128_IDR
    for blob in _mutations(rng, STREAM16 + H265_128_IDR):
        el = gt.make("h265parse")
        try:
            el.push(blob)
            el.finish()
        except OK_ERRORS:
            pass


def test_fuzz_av1(rng):
    blob0 = open(os.path.join(DATA, "av1_streams.bin"), "rb").read()
    idx = json.load(open(os.path.join(DATA, "av1_streams.json")))
    off, ln = idx["arrays"]["stream_no_annexb_av1"]
    stream = blob0[off:off + min(ln, 2000)]
    for blob in _mutations(rng, stream, n=25):
        el = gt.make("av1parse")
        el.set_output("obu-stream", "frame")
        try:
            el.push(blob)
            el.finish()
        except OK_ERRORS:
            pass


def test_fuzz_vp9(rng):
    blob0 = open(os.path.join(DATA, "vp9_frames.bin"), "rb").read()
    frame = blob0[:512]
    for blob in _mutations(rng, frame, n=25):
        el = gt.make("vp9parse")
        try:
            el.push(blob)
        except OK_ERRORS:
            pass


def test_fuzz_h263(rng):
    from tests.test_h263parse import H263_IFRAME
    for blob in _mutations(rng, H263_IFRAME):
        el = gt.make("h263parse")
        try:
            el.push(blob)
            el.finish()
        except OK_ERRORS:
            pass


def test_fuzz_gdp(rng):
    pkt = gdp.dp_payload_buffer(b"x" * 32,
                                flags=gdp.DP_FLAG_CRC_HEADER)
    for blob in _mutations(rng, pkt, n=25):
        try:
            list(gdp.dp_depay(blob))
        except OK_ERRORS:
            pass


def test_fuzz_uvch264(rng):
    mjpg = open(os.path.join(DATA, "uvch264",
                             "valid_h264_jpg.mjpg"), "rb").read()
    for blob in _mutations(rng, mjpg[:2048], n=25):
        try:
            uvch264.demux_mjpg(blob)
        except OK_ERRORS:
            pass


def test_fuzz_m3u8(rng):
    from tests.test_m3u8 import ON_DEMAND, VARIANT
    for base in (ON_DEMAND, VARIANT):
        data = base.encode()
        for blob in _mutations(rng, data, n=15):
            try:
                m3u8.load_master(blob.decode("latin1"),
                                 "http://localhost/x.m3u8")
            except OK_ERRORS:
                pass


def test_fuzz_dashmpd(rng):
    xml = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" profiles="p">'
           '<Period id="p" duration="PT10S"><AdaptationSet>'
           '<Representation id="r" bandwidth="1"/>'
           '</AdaptationSet></Period></MPD>').encode()
    for blob in _mutations(rng, xml, n=15):
        try:
            dashmpd.parse_mpd(blob.decode("latin1"))
        except OK_ERRORS:
            pass


def test_fuzz_mss_manifest(rng):
    from tests.test_mss import MANIFEST
    for blob in _mutations(rng, MANIFEST.encode(), n=20):
        try:
            m = __import__("gstbad.io.mss",
                           fromlist=["MssManifest"])
            man = m.MssManifest(blob)
            for s in man.streams:
                s.active = True
                s.get_caps()
                s.get_fragment_url()
        except OK_ERRORS:
            pass


def test_fuzz_isoff(rng):
    from gstbad.io import isoff, mss
    moof = open(os.path.join(DATA, "isoff", "moof1.bin"), "rb").read()
    frag = open(os.path.join(DATA, "isoff",
                             "Fragments_audio.bin"), "rb").read()
    blobs = list(_mutations(rng, moof, n=20)) \
        + list(_mutations(rng, frag[:512], n=10))
    for blob in blobs:
        try:
            isoff.parse_moof(blob)      # None or parse, never crash
            isoff.parse_moov(blob)
            p = isoff.SidxParser()
            p.parse(blob[:256])
            mss.MssFragmentParser().add_buffer(blob)
        except OK_ERRORS:
            pass


def test_fuzz_vc1(rng):
    from gstbad.io import vc1
    layer = vc1.make_sequence_layer(
        vc1.PROFILE_MAIN, vc1.StructC(profile=vc1.PROFILE_MAIN),
        320, 240, 2, 25, 1)
    for blob in _mutations(rng, layer, n=25):
        try:
            vc1.parse_sequence_layer(blob)
            vc1.parse_sequence_header(blob)
            if len(blob) >= 4:
                vc1.identify_next_bdu(blob)
        except OK_ERRORS:
            pass


def test_fuzz_opus(rng):
    from gstbad.io import opus
    import gstbad as gt
    pkt = bytes([16 << 3 | 3, 4]) + b"x" * 64
    for blob in _mutations(rng, pkt, n=25):
        try:
            opus.packet_parse(blob)
        except OK_ERRORS:
            pass
        el = gt.make("opusparse")
        try:
            el.chain(blob)
        except OK_ERRORS:
            pass
