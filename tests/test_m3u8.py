"""HLS m3u8 parser (ext/hls/m3u8.c) — transcription of the upstream
tests/check/elements/hlsdemux_m3u8.c cases (same playlists, same
expected values)."""

import pytest

from gstbad.io import m3u8

SEC = m3u8.GST_SECOND
BASE = "http://localhost/test.m3u8"

ON_DEMAND = ("#EXTM3U \n#EXT-X-TARGETDURATION:10\n"
             "#EXTINF:10,Test\nhttp://media.example.com/001.ts\n"
             "#EXTINF:10,Test\nhttp://media.example.com/002.ts\n"
             "#EXTINF:10,Test\nhttp://media.example.com/003.ts\n"
             "#EXTINF:10,Test\nhttp://media.example.com/004.ts\n"
             "#EXT-X-ENDLIST")

DOUBLES = ("#EXTM3U \n#EXT-X-TARGETDURATION:10\n"
           "#EXTINF:10.321,Test\nhttp://media.example.com/001.ts\n"
           "#EXTINF:9.6789,Test\nhttp://media.example.com/002.ts\n"
           "#EXTINF:10.2344,Test\nhttp://media.example.com/003.ts\n"
           "#EXTINF:9.92,Test\nhttp://media.example.com/004.ts\n"
           "#EXT-X-ENDLIST")

LIVE = ("#EXTM3U\n#EXT-X-TARGETDURATION:8\n"
        "#EXT-X-MEDIA-SEQUENCE:2680\n\n"
        "#EXTINF:8,\nhttps://priv.example.com/fileSequence2680.ts\n"
        "#EXTINF:8,\nhttps://priv.example.com/fileSequence2681.ts\n"
        "#EXTINF:8,\nhttps://priv.example.com/fileSequence2682.ts\n"
        "#EXTINF:8,\nhttps://priv.example.com/fileSequence2683.ts")

LIVE_ROTATED = ("#EXTM3U\n#EXT-X-TARGETDURATION:8\n"
                "#EXT-X-MEDIA-SEQUENCE:3001\n\n"
                "#EXTINF:8,\n"
                "https://priv.example.com/fileSequence3001.ts\n"
                "#EXTINF:8,\n"
                "https://priv.example.com/fileSequence3002.ts\n"
                "#EXTINF:8,\n"
                "https://priv.example.com/fileSequence3003.ts\n"
                "#EXTINF:8,\n"
                "https://priv.example.com/fileSequence3004.ts")

VARIANT = ("#EXTM3U \n"
           "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=128000\n"
           "http://example.com/low.m3u8\n"
           "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=256000\n"
           "http://example.com/mid.m3u8\n"
           "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=768000\n"
           "http://example.com/hi.m3u8\n"
           "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=65000,"
           "CODECS=\"mp4a.40.5\"\n"
           "http://example.com/audio-only.m3u8")

BYTE_RANGES = ("#EXTM3U \n#EXT-X-TARGETDURATION:40\n"
               "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000@100\n"
               "http://media.example.com/all.ts\n"
               "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000@1000\n"
               "http://media.example.com/all.ts\n"
               "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000@2000\n"
               "http://media.example.com/all.ts\n"
               "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000@3000\n"
               "http://media.example.com/all.ts\n#EXT-X-ENDLIST")

BYTE_RANGES_ACC = ("#EXTM3U \n#EXT-X-TARGETDURATION:40\n"
                   "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000\n"
                   "http://media.example.com/all.ts\n"
                   "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000\n"
                   "http://media.example.com/all.ts\n"
                   "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000\n"
                   "http://media.example.com/all.ts\n"
                   "#EXTINF:10,Test\n#EXT-X-BYTERANGE:1000\n"
                   "http://media.example.com/all.ts\n#EXT-X-ENDLIST")

ENCRYPTED = (
    "#EXTM3U \n#EXT-X-TARGETDURATION:10\n"
    "#EXTINF:10,Test\nhttp://media.example.com/mid/video-only-001.ts\n"
    "#EXT-X-KEY:METHOD=NONE\n"
    "#EXTINF:10,Test\nhttp://media.example.com/mid/video-only-002.ts\n"
    "#EXT-X-KEY:METHOD=AES-128,"
    "URI=\"https://priv.example.com/key.bin\"\n"
    "#EXTINF:10,Test\nhttp://media.example.com/mid/video-only-003.ts\n"
    "#EXT-X-KEY:METHOD=AES-128,"
    "URI=\"https://priv.example.com/key2.bin\","
    "IV=0x00000000000000000000000000000001\n"
    "#EXTINF:10,Test\nhttp://media.example.com/mid/video-only-004.ts\n"
    "#EXTINF:10,Test\nhttp://media.example.com/mid/video-only-005.ts\n"
    "#EXT-X-ENDLIST")

MAP_TAG = ("#EXTM3U \n#EXT-X-VERSION:7\n"
           "#EXT-X-MAP:URI=\"init1.mp4\",BYTERANGE=\"50@50\"\n"
           "#EXTINF:6.00000,\n#EXT-X-BYTERANGE:100@50\nmain.mp4\n"
           "#EXTINF:6.00000,\n#EXT-X-BYTERANGE:100@150\nmain.mp4\n"
           "#EXT-X-MAP:URI=\"init2.mp4\"\n"
           "#EXTINF:6.00000,\n#EXT-X-BYTERANGE:100@300\nmain.mp4\n"
           "#EXT-X-ENDLIST")


def load(data):
    master = m3u8.load_master(data, BASE)
    assert master is not None
    return master


def test_load_main_playlist_invalid():
    assert m3u8.load_master("#EXTM3 UINVALID", BASE) is None


def test_load_main_playlist_rendition():
    master = load(ON_DEMAND)
    assert master.is_simple
    assert len(master.default_variant.m3u8.files) == 4
    assert master.version == 0


@pytest.mark.parametrize("pl", [
    VARIANT,
    VARIANT.replace("\n", "\n\n"),           # empty lines
    VARIANT.replace("\n", "\r\n"),           # windows
    VARIANT.replace("\n", "\r\n\r\n"),       # windows + empty
])
def test_load_main_playlist_variant(pl):
    """dash of upstream tests 361-465: 4 variants sorted by bandwidth,
    default = first in document order."""
    master = load(pl)
    assert len(master.variants) == 4
    v = master.variants[0]
    assert v.bandwidth == 65000
    assert v.program_id == 1
    assert v.uri == "http://example.com/audio-only.m3u8"
    assert v.codecs == "mp4a.40.5"
    assert [x.bandwidth for x in master.variants] == \
        [65000, 128000, 256000, 768000]
    assert master.default_variant.bandwidth == 128000


def test_variant_with_missing_uri():
    pl = ("#EXTM3U \n"
          "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=128000\n"
          "http://example.com/low.m3u8\n"
          "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=256000\n\n"
          "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=768000\n"
          "http://example.com/hi.m3u8\n"
          "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=65000,"
          "CODECS=\"mp4a.40.5\"\n"
          "http://example.com/audio-only.m3u8")
    master = load(pl)
    assert len(master.variants) == 3


@pytest.mark.parametrize("pl", [
    ON_DEMAND,
    ON_DEMAND.replace("\n", "\n\n"),
    ON_DEMAND.replace("\n", "\r\n"),
    ON_DEMAND.replace("\n", "\r\n\r\n"),
])
def test_on_demand_playlist(pl):
    """test_on_demand_playlist + line-ending variants."""
    master = load(pl)
    m = master.default_variant.m3u8
    assert m.sequence == 0
    assert not m.is_live()
    assert len(m.files) == 4
    assert m.files[0].uri == "http://media.example.com/001.ts"
    assert m.files[0].sequence == 0
    assert m.files[3].uri == "http://media.example.com/004.ts"
    assert m.files[3].sequence == 3


def test_live_playlist():
    master = load(LIVE)
    m = master.default_variant.m3u8
    assert m.is_live()
    assert m.sequence == 2680
    assert len(m.files) == 4
    assert m.files[0].uri == \
        "https://priv.example.com/fileSequence2680.ts"
    assert m.files[0].sequence == 2680
    assert m.files[3].sequence == 2683
    start, stop = m.get_seek_range()
    assert start == 0
    assert stop / SEC == pytest.approx(8.0)


def test_live_playlist_rotated():
    """Sequence numbering keeps counting across rotated reloads."""
    master = load(LIVE)
    m = master.default_variant.m3u8
    assert m.files[0].sequence == 2680
    assert m.update(LIVE_ROTATED)
    assert m.files[0].sequence == 3001


def test_playlist_with_doubles_duration():
    master = load(DOUBLES)
    m = master.default_variant.m3u8
    durs = [f.duration / SEC for f in m.files]
    assert durs == pytest.approx([10.321, 9.6789, 10.2344, 9.92])
    start, stop = m.get_seek_range()
    assert start == 0
    assert stop / SEC == pytest.approx(10.321 + 9.6789 + 10.2344
                                       + 9.92)


def test_playlist_with_encryption():
    """test_playlist_with_encryption: default IV = sequence number."""
    master = load(ENCRYPTED)
    m = master.default_variant.m3u8
    assert len(m.files) == 5
    assert m.files[0].key is None
    assert m.files[1].key is None
    f = m.files[2]
    assert f.key == "https://priv.example.com/key.bin"
    assert f.iv == (2).to_bytes(16, "big")   # sequence-derived IV
    f = m.files[3]
    assert f.key == "https://priv.example.com/key2.bin"
    assert f.iv == (1).to_bytes(16, "big")   # explicit 0x...01
    f = m.files[4]
    assert f.key == "https://priv.example.com/key2.bin"
    assert f.iv == (1).to_bytes(16, "big")


def test_update_invalid_playlist():
    master = load(ON_DEMAND)
    m = master.default_variant.m3u8
    assert not m.update("#INVALID")
    assert len(m.files) == 4


def test_update_playlist():
    master = load(ON_DEMAND)
    m = master.default_variant.m3u8
    assert m.update(ON_DEMAND)
    assert len(m.files) == 4
    master = load(LIVE)
    m = master.default_variant.m3u8
    live_pl = LIVE + "\n#EXTINF:8\n" \
        "https://priv.example.com/fileSequence2684.ts"
    assert m.update(live_pl)
    assert len(m.files) == 5


def test_playlist_media_files():
    master = load(ON_DEMAND)
    f = master.default_variant.m3u8.files[0]
    assert f.uri == "http://media.example.com/001.ts"
    assert f.sequence == 0
    assert f.duration == 10 * SEC
    assert f.offset == 0 and f.size == -1
    assert f.title == "Test"


def test_byte_range_media_files():
    for pl in (BYTE_RANGES, BYTE_RANGES_ACC):
        master = load(pl)
        files = master.default_variant.m3u8.files
        assert len(files) == 4
        assert files[0].uri == "http://media.example.com/all.ts"
        assert files[0].size == 1000
        assert files[0].offset == (100 if pl is BYTE_RANGES else 0)
        assert files[3].offset == 3000
        assert files[3].size == 1000


def test_get_duration():
    assert load(ON_DEMAND).default_variant.m3u8.get_duration() \
        == 40 * SEC
    assert load(LIVE).default_variant.m3u8.get_duration() \
        == m3u8.CLOCK_TIME_NONE


def test_get_target_duration():
    assert load(ON_DEMAND).default_variant.m3u8 \
        .get_target_duration() == 10 * SEC


def test_get_stream_for_bitrate():
    master = load(VARIANT)
    assert master.get_variant_for_bitrate(0).bandwidth == 65000
    assert master.get_variant_for_bitrate(2 ** 31).bandwidth == 768000
    assert master.get_variant_for_bitrate(300000).bandwidth == 256000
    assert master.get_variant_for_bitrate(500000).bandwidth == 256000
    assert master.get_variant_for_bitrate(255000).bandwidth == 128000


def test_url_with_slash_query_param():
    pl = ("#EXTM3U \n#EXT-X-VERSION:4\n"
          "#EXT-X-STREAM-INF:PROGRAM-ID=1, BANDWIDTH=1251135, "
          "CODECS=\"avc1.42001f, mp4a.40.2\", RESOLUTION=640x352\n"
          "1251/media.m3u8?acl=/*1054559_h264_1500k.mp4\n")
    master = load(pl)
    assert len(master.variants) == 1
    assert master.variants[0].uri == \
        "http://localhost/1251/media.m3u8?acl=/*1054559_h264_1500k.mp4"


def test_stream_inf_tag():
    pl = ("#EXTM3U \n#EXT-X-VERSION:4\n"
          "#EXT-X-STREAM-INF:PROGRAM-ID=1, BANDWIDTH=1251135, "
          "CODECS=\"avc1.42001f, mp4a.40.2\", RESOLUTION=640x352\n"
          "media.m3u8\n")
    v = load(pl).variants[0]
    assert v.program_id == 1
    assert (v.width, v.height) == (640, 352)
    assert v.bandwidth == 1251135
    assert v.codecs == "avc1.42001f, mp4a.40.2"


def test_map_tag():
    """test_map_tag: init files shared by following segments."""
    master = load(MAP_TAG)
    assert master.is_simple
    m = master.default_variant.m3u8
    assert m.version == 7
    files = m.files
    assert len(files) == 3
    assert all(f.init_file is not None for f in files)
    assert files[0].init_file is files[1].init_file
    assert files[1].init_file is not files[2].init_file
    assert files[0].init_file.uri != files[2].init_file.uri
    assert files[0].init_file.uri == "http://localhost/init1.mp4"
    assert files[0].init_file.size == 50
    assert files[0].init_file.offset == 50
    assert files[2].init_file.size == -1
