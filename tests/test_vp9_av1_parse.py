"""vp9parse + av1parse (gst/videoparsers) — upstream unit-test
transcription over the upstream binary vectors (tests/data/*.bin,
carried as data from vp9parse.h / av1parse.h)."""

import json
import os

import pytest

import gstbad as gt
from gstbad.io import av1obu as av1
from gstbad.io import vp9

DATA = os.path.join(os.path.dirname(__file__), "data")

try:
    from gstbad.io import av1 as _aom
    _HAVE_AOM = _aom.available()
except Exception:
    _HAVE_AOM = False


def _vp9_frames():
    blob = open(os.path.join(DATA, "vp9_frames.bin"), "rb").read()
    idx = json.load(open(os.path.join(DATA, "vp9_frames.json")))
    return [blob[f["offset"]:f["offset"] + f["len"]]
            for f in idx["frames"]], idx


def _av1_streams():
    blob = open(os.path.join(DATA, "av1_streams.bin"), "rb").read()
    idx = json.load(open(os.path.join(DATA, "av1_streams.json")))
    arr = {k: blob[v[0]:v[0] + v[1]] for k, v in idx["arrays"].items()}
    return arr, idx["nums"]


# ------------------------------------------------------------------ vp9

def test_vp9_keyframe_header():
    """vp9parse.c:102-104: 256x144 profile 0."""
    frames, _ = _vp9_frames()
    h = vp9.parse_frame_header(frames[0])
    assert (h.width, h.height) == (256, 144)
    assert h.profile == 0 and h.bit_depth == 8
    assert h.frame_type == vp9.FRAME_KEY
    assert vp9.chroma_format(h) == "4:2:0"


def test_vp9_superframe_split():
    """vp9parse.h: the 6171-byte superframe = 5796 + 369."""
    frames, idx = _vp9_frames()
    sub = vp9.split_superframe(frames[1])
    assert [len(s) for s in sub] == [idx["first_len"], idx["last_len"]]
    assert vp9.split_superframe(frames[0]) == [frames[0]]


def test_vp9parse_element():
    """test_split_superframe (vp9parse.c:36-131): caps on the first
    frame, delta flags afterwards, decode-only for the hidden
    superframe member."""
    frames, idx = _vp9_frames()
    el = gt.make("vp9parse")
    out0 = el.push(frames[0])
    assert len(out0) == 1 and len(out0[0]["data"]) == len(frames[0])
    assert out0[0]["keyframe"] and not out0[0]["decode_only"]
    caps = el.src_caps
    assert caps["width"] == 256 and caps["height"] == 144
    assert caps["profile"] == "0"

    out1 = el.push(frames[1])
    assert [len(o["data"]) for o in out1] == [idx["first_len"],
                                              idx["last_len"]]
    assert out1[0]["decode_only"] and not out1[0]["keyframe"]
    assert not out1[1]["decode_only"]

    out2 = el.push(frames[2])
    assert len(out2) == 1 and not out2[0]["keyframe"]

    # super-frame alignment passes superframes through whole
    el2 = gt.make("vp9parse")
    el2.set_output("super-frame")
    assert [len(o["data"]) for o in el2.push(frames[1])] \
        == [len(frames[1])]


# ------------------------------------------------------------------ av1

def test_av1_obu_split_golden():
    arr, nums = _av1_streams()
    obus = av1.split_obu_stream(arr["stream_no_annexb_av1"])
    assert [len(o.raw) for o in obus] == nums["stream_av1_obu_size"]


def test_av1_sequence_header_golden():
    """av1parse.c:63-66: 400x300 profile 0 depth 8."""
    arr, _ = _av1_streams()
    obus = av1.split_obu_stream(arr["stream_no_annexb_av1"])
    sh = av1.parse_sequence_header(
        [o for o in obus if o.obu_type == av1.OBU_SEQUENCE_HEADER][0]
        .payload)
    assert (sh.max_width, sh.max_height) == (400, 300)
    assert sh.profile == 0 and sh.bit_depth == 8


def test_av1_byte_to_frame():
    """test_byte_to_frame: 14 frames with the exact upstream sizes,
    pushed in 5 arbitrary chunks."""
    arr, nums = _av1_streams()
    stream = arr["stream_no_annexb_av1"]
    el = gt.make("av1parse")
    el.set_output("obu-stream", "frame")
    outs = []
    ln = len(stream) // 5
    for i in range(5):
        chunk = stream[i * ln:(i + 1) * ln] if i < 4 else \
            stream[4 * ln:]
        outs += el.push(chunk)
    outs += el.finish()
    assert [len(o["data"]) for o in outs] == \
        nums["stream_av1_frame_size"]
    caps = el.src_caps
    assert caps["width"] == 400 and caps["height"] == 300
    assert caps["profile"] == "0"
    assert caps["bit-depth-chroma"] == 8


def test_av1_byte_to_annexb():
    """test_byte_to_annexb: the produced annex-b TUs match the
    upstream stream byte-exactly."""
    arr, nums = _av1_streams()
    el = gt.make("av1parse")
    el.set_output("annexb", "tu")
    outs = el.push(arr["stream_no_annexb_av1"]) + el.finish()
    assert [len(o["data"]) for o in outs] == \
        nums["stream_annexb_av1_tu_len"]
    assert b"".join(o["data"] for o in outs) == arr["stream_annexb_av1"]


def test_av1_annexb_to_obu():
    """test_annexb_to_obu: size-field re-added per obu."""
    arr, nums = _av1_streams()
    el = gt.make("av1parse")
    el.set_caps("annexb")
    el.set_output("obu-stream", "obu")
    outs = el.push(arr["stream_annexb_av1"]) + el.finish()
    assert [len(o["data"]) for o in outs] == nums["stream_av1_obu_size"]


def test_av1_annexb_to_frame():
    """test_annexb_to_frame."""
    arr, nums = _av1_streams()
    el = gt.make("av1parse")
    el.set_caps("annexb")
    el.set_output("obu-stream", "frame")
    outs = el.push(arr["stream_annexb_av1"]) + el.finish()
    assert [len(o["data"]) for o in outs] == \
        nums["stream_av1_frame_size"]


def test_av1_leb128_roundtrip():
    for v in (0, 1, 127, 128, 300, 5454, 10519, 1 << 30):
        enc = av1.write_leb128(v)
        dec, pos = av1.read_leb128(enc, 0)
        assert dec == v and pos == len(enc)


# ------------------------------------------- av1 frame-header parse

def test_av1_upstream_show_existing_headers():
    """The upstream stream's 3 standalone FRAME_HEADER OBUs are
    show_existing_frame headers; the full parse must agree and resolve
    their frame store slots (gstav1parser.c:3537-3596)."""
    arr, _ = _av1_streams()
    seq = None
    st = av1.ParserState()
    seen_types = []
    for o in av1.split_obu_stream(arr["stream_no_annexb_av1"]):
        if o.obu_type == av1.OBU_SEQUENCE_HEADER:
            seq = av1.parse_sequence_header(o.payload)
        elif o.obu_type in (av1.OBU_FRAME, av1.OBU_FRAME_HEADER):
            fh = av1.parse_frame_header(o, seq, st)
            if not fh.show_existing_frame or fh.frame_type == av1.FRAME_KEY:
                av1.reference_frame_update(st, fh)
            if o.obu_type == av1.OBU_FRAME_HEADER:
                assert fh.show_existing_frame
                assert st.ref[fh.frame_to_show_map_idx].valid
            else:
                assert not fh.show_existing_frame
                assert (fh.frame_width, fh.frame_height) == (400, 300)
                st.seen_frame_header = False  # the embedded tile group
            seen_types.append((o.obu_type, fh.frame_type))
    # 11 FRAME obus + 3 show_existing headers, first frame is a key
    assert len(seen_types) == 14
    assert seen_types[0] == (av1.OBU_FRAME, av1.FRAME_KEY)


@pytest.mark.skipif(not _HAVE_AOM, reason="libaom not present")
def test_av1_frame_header_real_aom_nonuniform_tiles():
    """Bit-exact header-parse check against a REAL libaom stream with
    an explicit (non-uniform) 2x2 tile layout: a single mis-read bit
    anywhere in the uncompressed header desyncs the ns() tile-size
    reads, so matching mi starts prove the parse position
    (gstav1parser.c:2296-2338 non-uniform tile_info)."""
    import ctypes
    import numpy as np
    from gstbad.io import av1 as aom

    tw = (ctypes.c_int * 64)()
    tw[0], tw[1] = 5, 3          # superblock widths at 512px = 8 sbs
    th = (ctypes.c_int * 64)()
    th[0], th[1] = 1, 3
    enc = aom.AV1Encoder(512, 256, cpu_used=8,
                         cfg_fields=dict(tile_width_count=2,
                                         tile_height_count=2,
                                         tile_widths=tw,
                                         tile_heights=th))
    rng = np.random.RandomState(7)
    pkts = []
    for _ in range(4):
        y = rng.randint(0, 255, (256, 512)).astype(np.uint8)
        u = rng.randint(0, 255, (128, 256)).astype(np.uint8)
        d = enc.encode(y, u, u.copy())
        if d:
            pkts.append(d)
    seq = None
    st = av1.ParserState()
    hints = []
    for p in pkts:
        for o in av1.split_obu_stream(p):
            if o.obu_type == av1.OBU_SEQUENCE_HEADER:
                seq = av1.parse_sequence_header(o.payload)
            elif o.obu_type in (av1.OBU_FRAME, av1.OBU_FRAME_HEADER):
                fh = av1.parse_frame_header(o, seq, st)
                if not fh.show_existing_frame \
                        or fh.frame_type == av1.FRAME_KEY:
                    av1.reference_frame_update(st, fh)
                if fh.show_existing_frame:
                    continue
                st.seen_frame_header = False
                assert (fh.tile_cols, fh.tile_rows) == (2, 2)
                # 5 sbs * 16 mi, 1 sb * 16 mi
                assert st.mi_col_starts == [0, 80, 128]
                assert st.mi_row_starts == [0, 16, 64]
                assert (fh.frame_width, fh.frame_height) == (512, 256)
                hints.append(fh.order_hint)
    assert len(hints) >= 4 and hints == sorted(hints)


class _BitW:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def to_bytes(self):
        while len(self.bits) % 8:
            self.bits.append(0)
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _obu(obu_type, payload):
    hdr = bytes([(obu_type << 3) | 0x02])  # has_size, no extension
    return hdr + av1.write_leb128(len(payload)) + payload


def _tg_seq_header():
    """512x256, order hints on (7 bits), superres/cdef off — the
    minimal spec-valid sequence header the fixture frames assume."""
    w = _BitW()
    w.put(0, 3)   # seq_profile
    w.put(0, 1)   # still_picture
    w.put(0, 1)   # reduced_still_picture_header
    w.put(0, 1)   # timing_info_present
    w.put(0, 1)   # initial_display_delay_present
    w.put(0, 5)   # operating_points_cnt_minus_1
    w.put(0, 12)  # operating_point_idc[0]
    w.put(0, 5)   # seq_level_idx[0] (<= 7: no tier bit)
    w.put(8, 4)   # frame_width_bits_minus_1 -> 9
    w.put(7, 4)   # frame_height_bits_minus_1 -> 8
    w.put(511, 9)  # max_frame_width_minus_1
    w.put(255, 8)  # max_frame_height_minus_1
    w.put(0, 1)   # frame_id_numbers_present
    w.put(0, 1)   # use_128x128_superblock
    w.put(0, 2)   # filter_intra, intra_edge_filter
    w.put(0, 4)   # interintra, masked, warped, dual_filter
    w.put(1, 1)   # enable_order_hint
    w.put(0, 2)   # jnt_comp, ref_frame_mvs
    w.put(1, 1)   # seq_choose_screen_content_tools -> SELECT
    w.put(1, 1)   # seq_choose_integer_mv -> SELECT
    w.put(6, 3)   # order_hint_bits_minus_1 -> 7
    w.put(0, 3)   # superres, cdef, restoration
    w.put(0, 1)   # high_bitdepth
    w.put(0, 1)   # monochrome
    w.put(0, 1)   # color_description_present
    w.put(0, 1)   # color_range
    w.put(0, 1)   # chroma_sample_position? (420: 2 bits)
    w.put(0, 1)
    w.put(0, 1)   # separate_uv_delta_q
    w.put(0, 1)   # film_grain_params_present
    w.put(1, 1)   # trailing one bit
    return _obu(av1.OBU_SEQUENCE_HEADER, w.to_bytes())


def _tg_key_frame_header(order_hint):
    """Shown keyframe, 2x2 uniform tiles, tile_size_bytes = 2."""
    w = _BitW()
    w.put(0, 1)   # show_existing_frame
    w.put(0, 2)   # frame_type KEY
    w.put(1, 1)   # show_frame (error_resilient implied)
    w.put(0, 1)   # disable_cdf_update
    w.put(0, 1)   # allow_screen_content_tools (seq SELECT)
    w.put(0, 1)   # frame_size_override_flag
    w.put(order_hint, 7)
    # KEY+show: refresh implied 0xFF; intra: sizes follow
    w.put(0, 1)   # render_and_frame_size_different
    w.put(1, 1)   # disable_frame_end_update_cdf
    # tile_info: uniform, cols_log2 1 (bits 1,0), rows_log2 1 (1,0)
    w.put(1, 1)   # uniform_tile_spacing_flag
    w.put(1, 1)
    w.put(0, 1)
    w.put(1, 1)
    w.put(0, 1)
    w.put(0, 2)   # context_update_tile_id
    w.put(1, 2)   # tile_size_bytes_minus_1 -> 2
    w.put(1, 1)   # trailing
    return _obu(av1.OBU_FRAME_HEADER, w.to_bytes())


def _tg_obu(tg_start, tg_end, tile_bits=2, tile_size_bytes=2,
            tile_payload=b"\xa5" * 9):
    w = _BitW()
    w.put(1, 1)            # tile_start_and_end_present_flag
    w.put(tg_start, tile_bits)
    w.put(tg_end, tile_bits)
    body = bytearray(w.to_bytes())  # byte_alignment built in
    for t in range(tg_start, tg_end + 1):
        if t < tg_end:
            sz = len(tile_payload) - 1
            body += sz.to_bytes(tile_size_bytes, "little")
        body += tile_payload
    return _obu(av1.OBU_TILE_GROUP, bytes(body))


def test_av1_standalone_tile_group_completion():
    """gstav1parse.c:1190-1197: a frame split into FRAME_HEADER +
    several TILE_GROUP OBUs completes only at tg_end == num_tiles-1
    (the round-2 divergence, now closed)."""
    td = _obu(av1.OBU_TEMPORAL_DELIMITER, b"")
    stream1 = td + _tg_seq_header() + _tg_key_frame_header(0) \
        + _tg_obu(0, 1)
    stream2 = _tg_obu(2, 3)
    stream3 = td + _tg_key_frame_header(1) + _tg_obu(0, 3)

    el = gt.make("av1parse")
    el.set_output("obu-stream", "frame")
    outs = el.push(stream1)
    assert outs == []          # 2 of 4 tiles: frame still open
    outs = el.push(stream2)
    assert len(outs) == 1      # tg_end == 3 closes it
    assert outs[0]["data"] == stream1 + stream2
    outs = el.push(stream3) + el.finish()
    assert len(outs) == 1
    assert outs[0]["data"] == stream3

    # sanity on the header parse itself
    seq = av1.parse_sequence_header(
        av1.split_obu_stream(_tg_seq_header())[0].payload)
    assert (seq.max_width, seq.max_height) == (512, 256)
    assert seq.order_hint_bits == 7
    st = av1.ParserState()
    fh = av1.parse_frame_header(
        av1.split_obu_stream(_tg_key_frame_header(3))[0], seq, st)
    assert fh.frame_type == av1.FRAME_KEY and fh.order_hint == 3
    assert (fh.tile_cols, fh.tile_rows, fh.tile_size_bytes) == (2, 2, 2)


def test_av1_tile_group_partial_does_not_flush_midframe():
    """A tile group that is NOT the last keeps seen_frame_header; the
    walk checks tile sizes against the payload."""
    seq = av1.parse_sequence_header(
        av1.split_obu_stream(_tg_seq_header())[0].payload)
    st = av1.ParserState()
    av1.parse_frame_header(
        av1.split_obu_stream(_tg_key_frame_header(0))[0], seq, st)
    assert st.seen_frame_header
    tg = av1.parse_tile_group(
        av1.split_obu_stream(_tg_obu(0, 2))[0].payload, st)
    assert (tg.tg_start, tg.tg_end, tg.num_tiles) == (0, 2, 4)
    assert [e[2] for e in tg.entries] == [9, 9, 9]
    assert st.seen_frame_header          # frame still open
    tg = av1.parse_tile_group(
        av1.split_obu_stream(_tg_obu(3, 3))[0].payload, st)
    assert tg.tg_end == 3
    assert not st.seen_frame_header      # closed
    with pytest.raises(ValueError):
        av1.parse_tile_group(
            av1.split_obu_stream(_tg_obu(0, 0))[0].payload, st)
