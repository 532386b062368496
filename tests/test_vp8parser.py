"""VP8 frame-header parser (gst-libs/gst/codecparsers) —
transcription of the upstream unit test
(tests/check/libs/vp8parser.c) over its canned key+inter frames."""

import pathlib

import pytest

from gstbad.io import vp8

DATA = pathlib.Path(__file__).parent / "data"
FRAME0 = (DATA / "vp8_frame_data_0.bin").read_bytes()
FRAME1 = (DATA / "vp8_frame_data_1.bin").read_bytes()


def test_vp8_parse_key_frame():
    """vp8parser.c test_vp8_parse_key_frame — every assertion."""
    parser = vp8.Parser()
    hdr = parser.parse_frame_header(FRAME0)
    assert hdr.key_frame is True
    assert hdr.first_part_size == 234
    assert hdr.width == 176
    assert hdr.height == 144

    adj = parser.mb_lf_adjust
    assert adj.loop_filter_adj_enable is True
    assert adj.mode_ref_lf_delta_update is True
    assert adj.ref_frame_delta == [2, 0, -2, -2]
    assert adj.mb_mode_delta == [4, -2, 2, 4]

    assert hdr.quant_indices.y_ac_qi == 4
    assert hdr.mb_no_skip_coeff is True

    # the range-decoder state at the end of the header
    # (gst_vp8_range_decoder_get_state)
    assert hdr.rd_range == 0xE8
    assert hdr.rd_value == 0x68
    assert hdr.rd_count == 1


def test_vp8_parse_inter_frame():
    """vp8parser.c test_vp8_parse_inter_frame — the inter frame needs
    the entropy state carried from the key frame."""
    parser = vp8.Parser()
    parser.parse_frame_header(FRAME0)
    hdr = parser.parse_frame_header(FRAME1)
    assert hdr.key_frame is False
    assert hdr.first_part_size == 98
    assert parser.mb_lf_adjust.loop_filter_adj_enable is True
    assert hdr.quant_indices.y_ac_qi == 4
    assert hdr.refresh_entropy_probs is True
    assert hdr.refresh_last is True
    assert hdr.mb_no_skip_coeff is True
    assert hdr.prob_skip_false == 131
    assert hdr.prob_intra == 224
    assert hdr.prob_last == 233
    assert hdr.prob_gf == 1
    assert hdr.rd_range == 0x8E
    assert hdr.rd_value == 0x85
    assert hdr.rd_count == 5


def test_vp8_key_frame_resets_state():
    """gstvp8parser.c:311-312: key frames re-init the parser."""
    parser = vp8.Parser()
    parser.parse_frame_header(FRAME0)
    parser.parse_frame_header(FRAME1)
    hdr = parser.parse_frame_header(FRAME0)  # key frame again
    assert hdr.key_frame and hdr.width == 176
    assert hdr.rd_range == 0xE8  # identical state to the first parse


def test_vp8_partition_sizes():
    parser = vp8.Parser()
    hdr = parser.parse_frame_header(FRAME0)
    num = 1 << hdr.log2_nbr_of_dct_partitions
    # partitions tile the post-chunk bytes exactly
    total = hdr.first_part_size + 3 * (num - 1) \
        + sum(hdr.partition_size[:num])
    assert total == len(FRAME0) - hdr.data_chunk_size
    assert all(s == 0 for s in hdr.partition_size[num:])


def test_vp8_errors():
    parser = vp8.Parser()
    with pytest.raises(vp8.Vp8Error):
        parser.parse_frame_header(b"\x00")
    with pytest.raises(vp8.Vp8Error):
        parser.parse_frame_header(FRAME0[:20])  # truncated partition
