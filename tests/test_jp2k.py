"""jp2kdecimator (gst/jp2kdecimator/) — synthetic codestreams.

The element never decodes packet bodies (boundaries come from SOP or
PLT), so hand-built streams with arbitrary bodies exercise exactly the
paths the reference element takes.
"""

import pytest

from gstbad.io import jp2k


def _siz(w=64, h=64, xt=64, yt=64, ncomp=1):
    out = jp2k.MARKER_SIZ.to_bytes(2, "big")
    out += (38 + 3 * ncomp).to_bytes(2, "big")
    out += (0).to_bytes(2, "big")
    for v in (w, h, 0, 0, xt, yt, 0, 0):
        out += v.to_bytes(4, "big")
    out += ncomp.to_bytes(2, "big")
    out += bytes([7, 1, 1]) * ncomp
    return out


def _cod(order=jp2k.LRCP, layers=2, decomps=2, sop=True, eph=False):
    scod = (0x02 if sop else 0) | (0x04 if eph else 0)
    out = jp2k.MARKER_COD.to_bytes(2, "big") + (12).to_bytes(2, "big")
    out += bytes([scod, order])
    out += layers.to_bytes(2, "big")
    out += bytes([0, decomps, 2, 2, 0, 0])
    return out


def _qcd():
    return jp2k._marker_buffer(jp2k.MARKER_QCD, bytes([0x20, 0x40]))


def _sop_packet(seqno, body):
    return (jp2k.MARKER_SOP.to_bytes(2, "big") + (4).to_bytes(2, "big")
            + seqno.to_bytes(2, "big") + body)


def _stream_sop(order=jp2k.LRCP, n_packets=6):
    bodies = [bytes([0x10 + i, 0x20 + i, 0x30 + i])
              for i in range(n_packets)]
    tile_payload = b"".join(_sop_packet(i, b) for i, b in
                            enumerate(bodies))
    sot = (jp2k.MARKER_SOT.to_bytes(2, "big") + (10).to_bytes(2, "big")
           + (0).to_bytes(2, "big")
           + (12 + 2 + len(tile_payload)).to_bytes(4, "big")
           + bytes([0, 1]))
    stream = (jp2k.MARKER_SOC.to_bytes(2, "big") + _siz()
              + _cod(order) + _qcd() + sot
              + jp2k.MARKER_SOD.to_bytes(2, "big") + tile_payload
              + jp2k.MARKER_EOC.to_bytes(2, "big"))
    return stream, bodies


def test_parse_and_byte_exact_roundtrip():
    stream, bodies = _stream_sop()
    hdr = jp2k.parse_main_header(stream)
    assert len(hdr.tiles) == 1
    t = hdr.tiles[0]
    assert (t.tx0, t.ty0, t.tx1, t.ty1) == (0, 0, 64, 64)
    assert [p.data for p in t.packets] == bodies
    assert [p.seqno for p in t.packets] == list(range(6))
    # re-serialization is byte-identical (nothing decimated)
    assert jp2k.write_main_header(hdr) == stream


def test_decimate_resolutions_lrcp():
    stream, bodies = _stream_sop(jp2k.LRCP)
    out = jp2k.decimate(stream, max_decomposition_levels=0)
    hdr = jp2k.parse_main_header(out)
    pkts = hdr.tiles[0].packets
    # LRCP with 2 layers x 3 resolutions: resolution index is pos % 3
    for i, p in enumerate(pkts):
        if i % 3 == 0:
            assert p.data == bodies[i]
        else:
            assert p.data == b"\x00"        # emptied
    # SOT tile-part size matches the re-serialized tile
    assert hdr.tiles[0].tile_part_size == \
        len(jp2k._write_tile(hdr.tiles[0]))


def test_decimate_layers_rpcl():
    stream, bodies = _stream_sop(jp2k.RPCL)
    out = jp2k.decimate(stream, max_layers=1)
    pkts = jp2k.parse_main_header(out).tiles[0].packets
    # RPCL with 1 precinct/component: layer index is pos % 2
    for i, p in enumerate(pkts):
        if i % 2 == 0:
            assert p.data == bodies[i]
        else:
            assert p.data == b"\x00"


def test_plt_mode_and_eph():
    bodies = [bytes([0x40 + i]) * (i + 2) for i in range(6)]
    tile_payload = b"".join(bodies)
    plt = jp2k._write_plt(0, [len(b) for b in bodies])
    sot = (jp2k.MARKER_SOT.to_bytes(2, "big") + (10).to_bytes(2, "big")
           + (0).to_bytes(2, "big")
           + (12 + len(plt) + 2 + len(tile_payload)).to_bytes(4, "big")
           + bytes([0, 1]))
    stream = (jp2k.MARKER_SOC.to_bytes(2, "big") + _siz()
              + _cod(sop=False, eph=True) + _qcd() + sot + plt
              + jp2k.MARKER_SOD.to_bytes(2, "big") + tile_payload
              + jp2k.MARKER_EOC.to_bytes(2, "big"))
    hdr = jp2k.parse_main_header(stream)
    assert [p.data for p in hdr.tiles[0].packets] == bodies
    assert jp2k.write_main_header(hdr) == stream

    out = jp2k.decimate(stream, max_decomposition_levels=1)
    hdr2 = jp2k.parse_main_header(out)
    pkts = hdr2.tiles[0].packets
    # layers 0/1 x resolutions 0,1,2: resolution 2 packets emptied; an
    # empty packet in eph mode serializes as 0x00 + EPH and the PLT
    # records length 3
    for i, p in enumerate(pkts):
        if i % 3 == 2:
            assert p.data == b"\x00" + jp2k.MARKER_EPH.to_bytes(2, "big")
        else:
            assert p.data == bodies[i]
    assert [l for i, l in enumerate(hdr2.tiles[0].plt) if i % 3 == 2] \
        == [3, 3]


def test_unsupported_markers_and_errors():
    stream, _ = _stream_sop()
    # splice an unsupported POC marker into the main header
    poc = (0xFF5F).to_bytes(2, "big") + (4).to_bytes(2, "big") + b"\x00\x00"
    pos = stream.index(jp2k.MARKER_QCD.to_bytes(2, "big"))
    bad = stream[:pos] + poc + stream[pos:]
    with pytest.raises(ValueError, match="POC"):
        jp2k.parse_main_header(bad)
    with pytest.raises(ValueError, match="SOC"):
        jp2k.parse_main_header(b"\x00\x00" + stream[2:])
    # neither SOP nor PLT -> rejected (jp2kcodestream.c:989)
    no_sop = stream.replace(_cod(), _cod(sop=False))
    with pytest.raises(ValueError, match="PLT or SOP"):
        jp2k.parse_main_header(no_sop)
