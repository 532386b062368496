"""Smooth Streaming manifest model (ext/smoothstreaming/
gstmssmanifest.c) + the fragment parser (gstmssfragmentparser.c)."""

import pathlib

import pytest

from gstbad.io import isoff, mss

DATA = pathlib.Path(__file__).parent / "data" / "isoff"

# the h264parse upstream SPS/PPS vectors as annex-B hex (32x24 main)
SPS_HEX = ("674d4015eca4bf2e02200000"
           "03002ee6b28001e2c5b2c0")
PPS_HEX = "68ebecb2"
H264_CPD = "00000001" + SPS_HEX + "00000001" + PPS_HEX

MANIFEST = f"""<?xml version="1.0"?>
<SmoothStreamingMedia MajorVersion="2" MinorVersion="0"
    Duration="120000000" TimeScale="10000000">
  <StreamIndex Type="video" Chunks="4" QualityLevels="2" MaxWidth="32"
      MaxHeight="24" TimeScale="10000000"
      Url="QualityLevels({{bitrate}})/Fragments(video={{start time}})">
    <QualityLevel Index="0" Bitrate="1000000" FourCC="H264"
        MaxWidth="32" MaxHeight="24" CodecPrivateData="{H264_CPD}"/>
    <QualityLevel Index="1" Bitrate="300000" FourCC="H264"
        MaxWidth="32" MaxHeight="24" CodecPrivateData="{H264_CPD}"/>
    <c d="30000000"/>
    <c d="30000000"/>
    <c d="30000000" r="2"/>
  </StreamIndex>
  <StreamIndex Type="audio" Index="0" FourCC="AACL"
      Url="QualityLevels({{bitrate}})/Fragments(audio={{start_time}})">
    <QualityLevel Bitrate="128000" SamplingRate="44100" Channels="2"
        BitsPerSample="16" PacketSize="4" AudioTag="255"
        FourCC="AACL"/>
    <c t="0" d="60000000"/>
    <c d="60000000"/>
  </StreamIndex>
</SmoothStreamingMedia>
"""


def _manifest():
    return mss.MssManifest(MANIFEST.encode())


# ------------------------------------------------------------ manifest

def test_streams_and_types():
    m = _manifest()
    assert not m.is_live
    assert [s.type for s in m.streams] == ["video", "audio"]
    assert m.get_timescale() == 10000000
    assert m.get_duration() == 120000000
    assert m.get_gst_duration() == 12_000_000_000


def test_fragment_list_builder_semantics():
    """t/d/n/r defaults (gstmssmanifest.c:137-204): numbers count up,
    times accumulate d*r."""
    m = _manifest()
    video = m.streams[0]
    assert [(f.number, f.time, f.duration, f.repetitions)
            for f in video.fragments] == [
        (0, 0, 30000000, 1),
        (1, 30000000, 30000000, 1),
        (2, 60000000, 30000000, 2),
    ]


def test_fragment_builder_backfills_missing_duration():
    """A <c> with no d gets (next.t - t) / r at the next node
    (gstmssmanifest.c:180-184)."""
    xml = b"""<SmoothStreamingMedia TimeScale="1000">
      <StreamIndex Type="video" Url="u({start time})">
        <QualityLevel Bitrate="1" FourCC="H264"/>
        <c t="0" r="2"/><c t="500" d="100"/>
      </StreamIndex></SmoothStreamingMedia>"""
    m = mss.MssManifest(xml)
    frags = m.streams[0].fragments
    assert frags[0].duration == 250  # (500 - 0) / 2
    assert frags[1].time == 500


def test_quality_sorted_ascending_and_url_template():
    m = _manifest()
    video = m.streams[0]
    video.active = True
    assert [q.bitrate for q in video.qualities] == [300000, 1000000]
    assert video.get_current_bitrate() == 300000
    assert video.get_fragment_url() == \
        "QualityLevels(300000)/Fragments(video=0)"
    audio = m.streams[1]
    audio.active = True
    assert audio.get_fragment_url() == \
        "QualityLevels(128000)/Fragments(audio=0)"


def test_advance_through_repetitions():
    m = _manifest()
    video = m.streams[0]
    video.active = True
    urls = []
    while True:
        urls.append(video.get_fragment_url())
        if not video.advance_fragment():
            break
    assert urls == [
        "QualityLevels(300000)/Fragments(video=0)",
        "QualityLevels(300000)/Fragments(video=30000000)",
        "QualityLevels(300000)/Fragments(video=60000000)",
        "QualityLevels(300000)/Fragments(video=90000000)",
    ]
    assert video.get_fragment_url() is None  # EOS
    # regress at EOS is EOS too (gstmssmanifest.c:1183-1185)
    assert not video.regress_fragment()


def test_fragment_timestamps_and_duration():
    m = _manifest()
    video = m.streams[0]
    video.active = True
    assert video.get_fragment_gst_timestamp() == 0
    assert video.get_fragment_gst_duration() == 3_000_000_000
    video.advance_fragment()
    assert video.get_fragment_gst_timestamp() == 3_000_000_000
    assert m.get_min_fragment_duration() == 3_000_000_000


def test_seek_with_repetitions():
    m = _manifest()
    video = m.streams[0]
    video.active = True
    final = video.seek(True, 9_500_000_000)  # inside rep 1 of frag 2
    assert video.current_fragment.number == 2
    assert video.fragment_repetition_index == 1
    assert final == 9_000_000_000
    # exact boundary reverse: steps back one repetition
    video.seek(False, 9_000_000_000)
    assert video.fragment_repetition_index == 0
    assert video.current_fragment.number == 2
    # snap-after advances
    video.seek(True, 3_500_000_000, snap_after=True)
    assert video.current_fragment.number == 2


def test_select_bitrate_walk():
    m = _manifest()
    video = m.streams[0]
    video.active = True
    assert video.select_bitrate(2_000_000)  # up to 1000000
    assert video.get_current_bitrate() == 1000000
    assert video.select_bitrate(500_000)   # back down
    assert video.get_current_bitrate() == 300000
    assert not video.select_bitrate(400_000)  # no change
    m.streams[1].active = True
    assert m.change_bitrate(0)  # 0 = maximum
    assert m.get_current_bitrate() == 1000000 + 128000


def test_video_caps_h264():
    m = _manifest()
    video = m.streams[0]
    caps = video.get_caps()
    assert caps["media"] == "video/x-h264"
    assert caps["stream-format"] == "avc"
    assert caps["width"] == 32 and caps["height"] == 24
    cd = caps["codec_data"]
    # the reference builds the avcC by hand (gstmssmanifest.c:556-610)
    sps = bytes.fromhex(SPS_HEX)
    pps = bytes.fromhex(PPS_HEX)
    assert cd[0] == 1
    assert cd[1:4] == sps[1:4]
    assert cd[4] == 0xFF and cd[5] == 0xE1
    assert cd[6:8] == len(sps).to_bytes(2, "big")
    assert cd[8:8 + len(sps)] == sps
    assert cd[8 + len(sps)] == 1
    assert cd[-len(pps):] == pps


def test_audio_caps_aacl_synthesizes_codec_data():
    """No CodecPrivateData for AACL -> AudioSpecificConfig from
    rate/channels (gstmssmanifest.c:745-782, 869-871)."""
    m = _manifest()
    audio = m.streams[1]
    caps = audio.get_caps()
    assert caps["media"] == "audio/mpeg" and caps["mpegversion"] == 4
    assert caps["rate"] == 44100 and caps["channels"] == 2
    assert caps["depth"] == 16
    assert caps["block_align"] == 4
    assert caps["bitrate"] == 128000
    # AAC-LC, freq index 4 (44100), 2 channels
    assert caps["codec_data"] == bytes([0x12, 0x10])


def test_audio_caps_waveformatex():
    """WaveFormatEx is consumed for params and stripped to the tail
    (gstmssmanifest.c:833-867)."""
    wfx = (b"\x61\x01"          # wFormatTag (WMA)
           + (2).to_bytes(2, "little")       # channels
           + (48000).to_bytes(4, "little")   # rate
           + (4000).to_bytes(4, "little")    # byte rate
           + (8192).to_bytes(2, "little")    # block align
           + (16).to_bytes(2, "little")      # bits
           + (4).to_bytes(2, "little")       # cbSize
           + b"\xde\xad\xbe\xef")
    xml = f"""<SmoothStreamingMedia TimeScale="1000">
      <StreamIndex Type="audio" Url="u({{start time}})">
        <QualityLevel Bitrate="9" FourCC="WmaPro"
            WaveFormatEx="{wfx.hex()}"/>
        <c t="0" d="100"/>
      </StreamIndex></SmoothStreamingMedia>"""
    caps = mss.MssManifest(xml.encode()).streams[0].get_caps()
    assert caps["media"] == "audio/x-wma" and caps["wmaversion"] == 3
    assert caps["channels"] == 2
    assert caps["rate"] == 48000
    assert caps["block_align"] == 8192
    assert caps["depth"] == 16
    assert caps["codec_data"] == b"\xde\xad\xbe\xef"


def test_audio_fourcc_fallback_to_subtype_and_audiotag():
    xml = """<SmoothStreamingMedia TimeScale="1000">
      <StreamIndex Type="audio" Subtype="AACL" Url="u({start time})">
        <QualityLevel Bitrate="9" SamplingRate="48000" Channels="1"/>
        <c t="0" d="100"/>
      </StreamIndex>
      <StreamIndex Type="audio" Url="u({start time})">
        <QualityLevel Bitrate="9" AudioTag="83"/>
        <c t="0" d="100"/>
      </StreamIndex></SmoothStreamingMedia>"""
    m = mss.MssManifest(xml.encode())
    aac = m.streams[0].get_caps()
    assert aac["media"] == "audio/mpeg" and aac["mpegversion"] == 4
    assert aac["codec_data"] == bytes([0x11, 0x88])  # 48k mono
    mp3 = m.streams[1].get_caps()
    assert mp3 == {"media": "audio/mpeg", "mpegversion": 1, "layer": 3,
                   "bitrate": 9}


def test_live_starts_three_fragments_from_end():
    """GST_MSSMANIFEST_LIVE_MIN_FRAGMENT_DISTANCE=3
    (gstmssmanifest.c:57, 290-302)."""
    chunks = "".join('<c d="100"/>' for _ in range(10))
    xml = f"""<SmoothStreamingMedia TimeScale="1000" IsLive="TRUE"
        DVRWindowLength="500" LookAheadFragmentCount="2">
      <StreamIndex Type="video" Url="u({{start time}})">
        <QualityLevel Bitrate="1" FourCC="H264"/>{chunks}
      </StreamIndex></SmoothStreamingMedia>"""
    m = mss.MssManifest(xml.encode())
    assert m.is_live
    assert m.look_ahead_fragment_count == 2
    stream = m.streams[0]
    assert stream.has_live_fragments
    assert stream.current_fragment.number == 6  # 3 from the end
    stream.active = True
    start, stop = m.get_live_seek_range()
    assert stop == 1_000_000_000
    assert start == 500_000_000  # DVR window


def test_reload_fragments_keeps_position():
    m = _manifest()
    video = m.streams[0]
    video.active = True
    video.advance_fragment()  # at t=30000000
    chunks = """<SmoothStreamingMedia>
      <StreamIndex Type="video">
        <c t="30000000" d="30000000"/><c d="30000000" r="3"/>
      </StreamIndex>
      <StreamIndex Type="audio"><c t="0" d="60000000"/></StreamIndex>
    </SmoothStreamingMedia>"""
    m.reload_fragments(chunks.encode())
    assert len(video.fragments) == 2
    assert video.get_fragment_gst_timestamp() == 3_000_000_000


def test_protection_header():
    xml = """<SmoothStreamingMedia TimeScale="1000">
      <Protection>
        <ProtectionHeader SystemID="{9A04F079-9840-4286-AB92-E65BE0885F95}">QmFzZTY0</ProtectionHeader>
      </Protection>
      <StreamIndex Type="video" Url="u({start time})">
        <QualityLevel Bitrate="1" FourCC="H264"/><c t="0" d="1"/>
      </StreamIndex></SmoothStreamingMedia>"""
    m = mss.MssManifest(xml.encode())
    assert m.protection_system_id == \
        "9a04f079-9840-4286-ab92-e65be0885f95"
    assert m.protection_data == "QmFzZTY0"


def test_duration_falls_back_to_active_stream():
    xml = """<SmoothStreamingMedia TimeScale="1000">
      <StreamIndex Type="video" Url="u({start time})">
        <QualityLevel Bitrate="1" FourCC="H264"/>
        <c t="0" d="100" r="4"/>
      </StreamIndex></SmoothStreamingMedia>"""
    m = mss.MssManifest(xml.encode())
    assert m.get_duration() == -1  # nothing active
    m.streams[0].active = True
    assert m.get_duration() == 400
    assert m.get_gst_duration() == 400_000_000


def test_invalid_manifest_raises():
    with pytest.raises(mss.MssError):
        mss.MssManifest(b"not xml at all <<<")


# ----------------------------------------------------- fragment parser

def test_fragment_parser_over_upstream_fragment():
    """gstmssfragmentparser.c over the canned MSS audio fragment
    (needs moof with tfxd + tfrf followed by mdat)."""
    moof = (DATA / "Fragments_audio.bin").read_bytes()
    mdat = (8 + 4).to_bytes(4, "big") + b"mdat" + b"\x00" * 4
    parser = mss.MssFragmentParser()
    assert parser.add_buffer(moof + mdat)
    assert parser.finished
    traf = parser.moof.traf[0]
    assert traf.tfxd.time == 1188108174758706
    assert len(traf.tfrf.entries) == 2
    # a fragment without tfxd/tfrf fails the sanity check
    plain = (DATA / "seg_2_m4f.bin").read_bytes()
    parser2 = mss.MssFragmentParser()
    assert not parser2.add_buffer(plain + mdat)


def test_stream_parse_fragment_grows_live_list():
    """tfrf look-ahead entries extend the live fragment list
    (gstmssmanifest.c:1652-1680); entries at or before the tail are
    skipped."""
    moof = (DATA / "Fragments_audio.bin").read_bytes()
    mdat = (8 + 4).to_bytes(4, "big") + b"mdat" + b"\x00" * 4
    xml = """<SmoothStreamingMedia TimeScale="10000000" IsLive="TRUE"
        LookAheadFragmentCount="2">
      <StreamIndex Type="audio" FourCC="AACL" Url="u({start time})">
        <QualityLevel Bitrate="1" SamplingRate="44100" Channels="2"/>
        <c t="1188108174758706" d="19969161"/>
      </StreamIndex></SmoothStreamingMedia>"""
    m = mss.MssManifest(xml.encode())
    stream = m.streams[0]
    assert mss.stream_parse_fragment(stream, moof + mdat)
    assert len(stream.fragments) == 3
    assert stream.fragments[1].time == 1188108194727867
    assert stream.fragments[1].duration == 19969160
    assert stream.fragments[2].time == 1188108214697027
    assert stream.fragments[1].number == 1
    # feeding again adds nothing (entries not newer than the tail)
    assert not mss.stream_parse_fragment(stream, moof + mdat)
