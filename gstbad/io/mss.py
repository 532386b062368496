"""Microsoft Smooth Streaming manifest model
(ext/smoothstreaming/gstmssmanifest.c) + the fragment-header parser
(gstmssfragmentparser.c over io/isoff.py).

Transcribed semantics:
  - fragment list building from <c> nodes: n (number) defaults to
    previous+1, t (time) defaults to the accumulated time, d
    (duration) may be deferred and back-filled from the NEXT
    fragment's t ((next.t - this.t) / this.repetitions), r
    (repetitions) defaults to 1 (gstmssmanifest.c:137-204);
  - qualities sorted ascending by Bitrate; live streams start
    GST_MSSMANIFEST_LIVE_MIN_FRAGMENT_DISTANCE=3 fragments from the
    end (gstmssmanifest.c:290-306);
  - fragment URLs: the stream's Url template with {bitrate}/{Bitrate}
    and {start time}/{start_time} literal replacements
    (gstmssmanifest.c:313-314, 1053-1085);
  - timescale: stream node, else root node, else 10000000
    (gstmssmanifest.c:918-950);
  - duration: root Duration, else the active streams' last fragment
    end (gstmssmanifest.c:953-990);
  - caps mapping: H264/AVC1 -> video/x-h264 avc (codec private data =
    two annex-B hex blobs -> avcC), WVC1 -> video/x-wmv WVC1 (raw hex
    codec_data), AACL -> audio/mpeg v4 (synthesized AudioSpecificConfig
    when CodecPrivateData is absent), WmaPro/WMAP -> audio/x-wma v3,
    AudioTag 83 -> mp3 / 255 -> aac, WaveFormatEx consumed for
    channels/rate/block_align/depth then stripped to the private tail
    (gstmssmanifest.c:507-905);
  - seek with repetition indexing + snap flags, advance/regress across
    repetitions, bitrate selection walk, live fragment reload keyed on
    current position (gstmssmanifest.c:1136-1479);
  - protection: first ProtectionHeader node, SystemID lowercased with
    {} braces stripped (gstmssmanifest.c:318-350).
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from gstbad.io import isoff

GST_SECOND = 1_000_000_000
DEFAULT_TIMESCALE = 10000000
LIVE_MIN_FRAGMENT_DISTANCE = 3  # gstmssmanifest.c:57

# AAC sampling rates (gstmssmanifest.c:731-733)
AAC_SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000,
                    22050, 16000, 12000, 11025, 8000, 7350]


class MssError(ValueError):
    pass


def _scale_round(v: int, num: int, den: int) -> int:
    return (v * num + den // 2) // den


@dataclasses.dataclass
class Fragment:
    number: int = 0
    time: int = 0
    duration: int = 0
    repetitions: int = 1


@dataclasses.dataclass
class Quality:
    node: ET.Element = None
    bitrate: int = 0
    bitrate_str: str = ""
    parent: ET.Element = None  # the StreamIndex node (Subtype fallback)


def _build_fragment_list(nodes) -> List[Fragment]:
    """gst_mss_fragment_list_builder (gstmssmanifest.c:127-204)."""
    fragments: List[Fragment] = []
    previous: Optional[Fragment] = None
    number = 0
    time_accum = 0
    for node in nodes:
        f = Fragment()
        seq = node.get("n")
        if seq is not None:
            f.number = int(seq)
        else:
            f.number = number
        number = f.number + 1
        rep = node.get("r")
        f.repetitions = int(rep) if rep is not None else 1
        t = node.get("t")
        if t is not None:
            f.time = int(t)
            time_accum = f.time
        else:
            f.time = time_accum
        if previous is not None:
            previous.duration = \
                (f.time - previous.time) // previous.repetitions
        d = node.get("d")
        if d is not None:
            f.duration = int(d)
            previous = None
            time_accum += f.duration * f.repetitions
        else:
            previous = f
        fragments.append(f)
    return fragments


def _hex_to_bytes(s: str) -> bytes:
    return bytes.fromhex(s)


def _make_h264_codec_data(sps: bytes, pps: bytes) -> Optional[bytes]:
    """_make_h264_codec_data (gstmssmanifest.c:556-610): a one-SPS,
    one-PPS avcC with 4-byte nal lengths."""
    if len(sps) < 4:
        return None
    out = bytearray()
    out += bytes([1, sps[1], sps[2], sps[3], 0xFC | 3, 0xE0 | 1])
    out += len(sps).to_bytes(2, "big") + sps
    out += bytes([1]) + len(pps).to_bytes(2, "big") + pps
    return bytes(out)


def _make_aacl_codec_data(rate: int, channels: int) -> bytes:
    """_make_aacl_codec_data (gstmssmanifest.c:745-782)."""
    try:
        freq_index = AAC_SAMPLE_RATES.index(rate)
    except ValueError:
        freq_index = 15
    size = 2 + (3 if freq_index == 15 else 0)
    data = bytearray(size)
    data[0] = (2 << 3) + (freq_index >> 1)  # AAC-LC
    data[1] = (freq_index & 1) << 7
    if freq_index == 15:
        data[1] += rate >> 17
        data[2] = (rate >> 9) & 0xFF
        data[3] = (rate >> 1) & 0xFF
        data[4] = rate & 0x01
        data[1 + 3] += (channels & 0x0F) << 3
    else:
        data[1] += (channels & 0x0F) << 3
    return bytes(data)


def _video_caps(q: Quality) -> Optional[Dict]:
    node = q.node
    fourcc = node.get("FourCC")
    if fourcc in ("H264", "AVC1"):
        caps = {"media": "video/x-h264", "stream-format": "avc"}
    elif fourcc == "WVC1":
        caps = {"media": "video/x-wmv", "wmvversion": 3,
                "format": "WVC1"}
    else:
        return None
    width = node.get("MaxWidth") or node.get("Width")
    height = node.get("MaxHeight") or node.get("Height")
    if width:
        caps["width"] = int(width)
    if height:
        caps["height"] = int(height)
    codec_data = node.get("CodecPrivateData")
    if codec_data:
        if fourcc in ("H264", "AVC1"):
            if codec_data.startswith("00000001"):
                rest = codec_data[8:]
                pos = rest.find("00000001")
                if pos >= 0:
                    sps = _hex_to_bytes(rest[:pos])
                    pps = _hex_to_bytes(rest[pos + 8:])
                    avcc = _make_h264_codec_data(sps, pps)
                    if avcc is not None:
                        caps["codec_data"] = avcc
                    try:
                        from gstbad.io import h264 as h
                        parsed = h.parse_sps(sps)
                        if parsed.fps_n and parsed.fps_d:
                            caps["framerate"] = (parsed.fps_n,
                                                 parsed.fps_d)
                    except ValueError:
                        pass
        else:
            caps["codec_data"] = _hex_to_bytes(codec_data)
    return caps


def _audio_caps(q: Quality) -> Optional[Dict]:
    node = q.node
    fourcc = node.get("FourCC")
    if not fourcc and q.parent is not None:
        # fall back to the StreamIndex Subtype (gstmssmanifest.c:807)
        fourcc = q.parent.get("Subtype")
    atag = int(node.get("AudioTag") or 0)
    caps: Optional[Dict] = None
    if fourcc == "AACL":
        caps = {"media": "audio/mpeg", "mpegversion": 4}
    elif fourcc in ("WmaPro", "WMAP"):
        caps = {"media": "audio/x-wma", "wmaversion": 3}
    elif atag == 83:
        caps = {"media": "audio/mpeg", "mpegversion": 1, "layer": 3}
    elif atag == 255:
        caps = {"media": "audio/mpeg", "mpegversion": 4}
    if caps is None:
        return None
    rate = int(node.get("SamplingRate") or 0)
    channels = int(node.get("Channels") or 0)
    depth = int(node.get("BitsPerSample") or 0)
    block_align = int(node.get("PacketSize") or 0)
    codec_data = None
    cd_str = node.get("CodecPrivateData")
    if cd_str:
        codec_data = _hex_to_bytes(cd_str)
    if codec_data is None:
        wfx_str = node.get("WaveFormatEx")
        if wfx_str is not None:
            if len(wfx_str) // 2 >= 18:
                wfx = _hex_to_bytes(wfx_str)
                if not channels:
                    channels = int.from_bytes(wfx[2:4], "little")
                if not rate:
                    rate = int.from_bytes(wfx[4:8], "little")
                if not block_align:
                    block_align = int.from_bytes(wfx[12:14], "little")
                if not depth:
                    depth = int.from_bytes(wfx[14:16], "little")
                codec_data = wfx[18:]  # strip the WAVEFORMATEX header
    if codec_data is None and (fourcc == "AACL" or atag == 255) \
            and rate and channels:
        codec_data = _make_aacl_codec_data(rate, channels)
    if block_align:
        caps["block_align"] = block_align
    if channels:
        caps["channels"] = channels
    if rate:
        caps["rate"] = rate
    if depth:
        caps["depth"] = depth
    if q.bitrate:
        caps["bitrate"] = q.bitrate
    if codec_data is not None:
        caps["codec_data"] = codec_data
    return caps


class MssStream:
    def __init__(self, manifest: "MssManifest", node: ET.Element):
        self.manifest = manifest
        self.node = node
        self.url = node.get("Url")
        self.lang = node.get("Language")
        self.active = False
        self.fragments: List[Fragment] = []
        self.qualities: List[Quality] = []
        self.fragment_repetition_index = 0
        self.has_live_fragments = (manifest.is_live
                                   and manifest.look_ahead_fragment_count
                                   > 0)
        for child in node:
            if child.tag == "c":
                pass  # parsed below in document order
            elif child.tag == "QualityLevel":
                q = Quality(node=child, parent=node,
                            bitrate_str=child.get("Bitrate") or "")
                q.bitrate = int(q.bitrate_str) if q.bitrate_str else 0
                self.qualities.append(q)
        self.fragments = _build_fragment_list(
            [c for c in node if c.tag == "c"])
        if self.fragments:
            if manifest.is_live:
                idx = max(0, len(self.fragments) - 1
                          - LIVE_MIN_FRAGMENT_DISTANCE)
                self.current_fragment_index = idx
            else:
                self.current_fragment_index = 0
        else:
            self.current_fragment_index = None
        self.qualities.sort(key=lambda q: q.bitrate)
        self.current_quality_index = 0 if self.qualities else None

    # -- basic getters ---------------------------------------------------

    @property
    def type(self) -> str:
        t = self.node.get("Type")
        if t in ("video", "audio"):
            return t
        return "unknown"

    @property
    def current_fragment(self) -> Optional[Fragment]:
        if self.current_fragment_index is None \
                or self.current_fragment_index >= len(self.fragments):
            return None
        return self.fragments[self.current_fragment_index]

    @property
    def current_quality(self) -> Optional[Quality]:
        if self.current_quality_index is None:
            return None
        return self.qualities[self.current_quality_index]

    def get_timescale(self) -> int:
        ts = self.node.get("TimeScale")
        if ts is None:
            ts = self.manifest.root.get("TimeScale")
        return int(ts) if ts is not None else DEFAULT_TIMESCALE

    def get_caps(self) -> Optional[Dict]:
        if self.current_quality is None:
            return None
        if self.type == "video":
            return _video_caps(self.current_quality)
        if self.type == "audio":
            return _audio_caps(self.current_quality)
        return None

    # -- fragment iteration ------------------------------------------------

    def get_fragment_url(self) -> Optional[str]:
        """gst_mss_stream_get_fragment_url: {bitrate} and {start time}
        template replacement; None at EOS."""
        if not self.active:
            raise MssError("stream not active")
        frag = self.current_fragment
        if frag is None:
            return None
        quality = self.current_quality
        time = frag.time \
            + frag.duration * self.fragment_repetition_index
        url = re.sub(r"\{[Bb]itrate\}", quality.bitrate_str, self.url)
        return re.sub(r"\{start[ _]time\}", str(time), url)

    def get_fragment_gst_timestamp(self) -> int:
        frag = self.current_fragment
        timescale = self.get_timescale()
        if frag is None:
            if not self.fragments:
                return isoff.CLOCK_TIME_NONE
            last = self.fragments[-1]
            time = last.time + last.duration * last.repetitions
        else:
            time = frag.time \
                + frag.duration * self.fragment_repetition_index
        return _scale_round(time, GST_SECOND, timescale)

    def get_fragment_gst_duration(self) -> int:
        frag = self.current_fragment
        if frag is None:
            return isoff.CLOCK_TIME_NONE
        return _scale_round(frag.duration, GST_SECOND,
                            self.get_timescale())

    def has_next_fragment(self) -> bool:
        if not self.active:
            raise MssError("stream not active")
        return self.current_fragment is not None

    def advance_fragment(self) -> bool:
        """True on OK, False on EOS (gstmssmanifest.c:1146-1175)."""
        if not self.active:
            raise MssError("stream not active")
        frag = self.current_fragment
        if frag is None:
            return False
        self.fragment_repetition_index += 1
        if self.fragment_repetition_index < frag.repetitions:
            return True
        self.fragment_repetition_index = 0
        self.current_fragment_index += 1
        return self.current_fragment is not None

    def regress_fragment(self) -> bool:
        if not self.active:
            raise MssError("stream not active")
        if self.current_fragment is None:
            return False
        if self.fragment_repetition_index == 0:
            if self.current_fragment_index == 0:
                return False
            self.current_fragment_index -= 1
            self.fragment_repetition_index = \
                self.current_fragment.repetitions - 1
        else:
            self.fragment_repetition_index -= 1
        return True

    def seek(self, forward: bool, time_ns: int,
             snap_after: bool = False) -> Optional[int]:
        """gst_mss_stream_seek (gstmssmanifest.c:1242-1309); returns
        the final time in ns."""
        timescale = self.get_timescale()
        time = _scale_round(time_ns, timescale, GST_SECOND)
        frag = None
        for i, f in enumerate(self.fragments):
            if f.time + f.repetitions * f.duration > time:
                frag = f
                self.current_fragment_index = i
                self.fragment_repetition_index = \
                    (time - f.time) // f.duration if f.duration else 0
                if f.duration and (time - f.time) % f.duration == 0:
                    if not forward:
                        self.fragment_repetition_index -= 1
                elif snap_after:
                    self.fragment_repetition_index += 1
                if self.fragment_repetition_index == f.repetitions:
                    self.fragment_repetition_index = 0
                    self.current_fragment_index = i + 1
                    frag = self.current_fragment
                elif self.fragment_repetition_index == -1:
                    if i > 0:
                        self.current_fragment_index = i - 1
                        frag = self.current_fragment
                        self.fragment_repetition_index = \
                            frag.repetitions - 1
                    else:
                        self.fragment_repetition_index = 0
                break
        if frag is not None:
            return _scale_round(
                frag.time
                + self.fragment_repetition_index * frag.duration,
                GST_SECOND, timescale)
        if self.fragments:
            last = self.fragments[-1]
            return _scale_round(
                last.time + last.repetitions * last.duration,
                GST_SECOND, timescale)
        return None

    # -- bitrate ------------------------------------------------------------

    def select_bitrate(self, bitrate: int) -> bool:
        """gst_mss_stream_select_bitrate walk
        (gstmssmanifest.c:1409-1446)."""
        if self.current_quality_index is None:
            return False
        idx = self.current_quality_index
        while self.qualities[idx].bitrate > bitrate and idx > 0:
            idx -= 1
        while self.qualities[idx].bitrate < bitrate:
            if idx + 1 < len(self.qualities) \
                    and self.qualities[idx + 1].bitrate < bitrate:
                idx += 1
            else:
                break
        if idx == self.current_quality_index:
            return False
        self.current_quality_index = idx
        return True

    def get_current_bitrate(self) -> int:
        q = self.current_quality
        return q.bitrate if q else 0

    # -- live reload ---------------------------------------------------------

    def reload_fragments(self, node: ET.Element) -> None:
        """gst_mss_stream_reload_fragments: rebuild the list and
        re-seek to the current position."""
        current = self.get_fragment_gst_timestamp()
        fragments = _build_fragment_list(
            [c for c in node if c.tag == "c"])
        if fragments:
            self.fragments = fragments
            self.current_fragment_index = 0
            if current != isoff.CLOCK_TIME_NONE:
                self.seek(True, current)


class MssManifest:
    def __init__(self, data: bytes):
        try:
            self.root = ET.fromstring(data)
        except ET.ParseError as e:
            raise MssError(f"invalid manifest: {e}") from e
        live = self.root.get("IsLive")
        self.is_live = bool(live) and live.lower() == "true"
        self.dvr_window = 0
        if self.is_live:
            dvr = self.root.get("DVRWindowLength")
            if dvr is not None:
                self.dvr_window = int(dvr)
        look = self.root.get("LookAheadFragmentCount")
        self.look_ahead_fragment_count = int(look) if look else 0
        self.protection_system_id: Optional[str] = None
        self.protection_data: Optional[str] = None
        self.streams: List[MssStream] = []
        for child in self.root:
            if child.tag == "StreamIndex":
                self.streams.append(MssStream(self, child))
            elif child.tag == "Protection":
                self._parse_protection(child)

    def _parse_protection(self, node: ET.Element) -> None:
        """gstmssmanifest.c:318-350: SystemID lowercased, braces
        stripped."""
        for child in node:
            if child.tag == "ProtectionHeader":
                system_id = child.get("SystemID") or ""
                if system_id.startswith("{"):
                    system_id = system_id[1:]
                system_id = system_id.lower()
                if system_id.endswith("}"):
                    system_id = system_id[:-1]
                self.protection_system_id = system_id
                self.protection_data = child.text
                break

    def get_timescale(self) -> int:
        ts = self.root.get("TimeScale")
        return int(ts) if ts is not None else DEFAULT_TIMESCALE

    def get_duration(self) -> int:
        """Root Duration, else max active stream's last fragment end
        (gstmssmanifest.c:953-990)."""
        dur_str = self.root.get("Duration")
        dur = int(dur_str) if dur_str else -1
        if dur <= 0:
            dur = -1
            for stream in self.streams:
                if stream.active and stream.fragments:
                    last = stream.fragments[-1]
                    end = last.time + last.duration * last.repetitions
                    dur = max(dur, end)
        return dur

    def get_gst_duration(self) -> int:
        duration = self.get_duration()
        if duration == -1:
            return isoff.CLOCK_TIME_NONE
        return _scale_round(duration, GST_SECOND, self.get_timescale())

    def get_min_fragment_duration(self) -> int:
        durs = [s.get_fragment_gst_duration() for s in self.streams]
        durs = [d for d in durs
                if d not in (isoff.CLOCK_TIME_NONE, 0)]
        return min(durs) if durs else isoff.CLOCK_TIME_NONE

    def get_current_bitrate(self) -> int:
        return sum(s.get_current_bitrate() for s in self.streams
                   if s.active and s.current_quality)

    def seek(self, forward: bool, time_ns: int) -> None:
        for stream in self.streams:
            stream.seek(forward, time_ns)

    def change_bitrate(self, bitrate: int) -> bool:
        """gst_mss_manifest_change_bitrate: 0 means maximum."""
        if bitrate == 0:
            bitrate = (1 << 64) - 1
        changed = False
        for stream in self.streams:
            if stream.active:
                changed |= stream.select_bitrate(bitrate)
        return changed

    def reload_fragments(self, data: bytes) -> None:
        root = ET.fromstring(data)
        nodes = [c for c in root if c.tag == "StreamIndex"]
        for stream, node in zip(self.streams, nodes):
            stream.reload_fragments(node)

    def get_live_seek_range(self) -> Optional[Tuple[int, int]]:
        """gst_mss_manifest_get_live_seek_range
        (gstmssmanifest.c:1549-1598): per active stream start = first
        fragment time, stop = last fragment end (the LAST active
        stream wins, like the reference loop), then clamp start to the
        DVR window when the range exceeds it."""
        rng = None
        for stream in self.streams:
            if not stream.active:
                continue
            if not stream.fragments:
                return None
            timescale = stream.get_timescale()
            first, last = stream.fragments[0], stream.fragments[-1]
            rng = (_scale_round(first.time, GST_SECOND, timescale),
                   _scale_round(last.time
                                + last.duration * last.repetitions,
                                GST_SECOND, timescale))
        if rng is None or not self.is_live:
            return rng
        start, stop = rng
        if self.dvr_window:
            dvr_ns = _scale_round(self.dvr_window, GST_SECOND,
                                  self.get_timescale())
            if stop - start > dvr_ns:
                start = stop - dvr_ns
        return (start, stop)


class MssFragmentParser:
    """gstmssfragmentparser.c: walk top-level boxes of a fragment,
    parse the moof, stop at mdat; requires tfxd + tfrf in the first
    traf."""

    def __init__(self):
        self.moof: Optional[isoff.MoofBox] = None
        self.finished = False

    def clear(self):
        self.moof = None
        self.finished = False

    def add_buffer(self, data: bytes) -> bool:
        r = isoff.ByteReader(data)
        current = b""
        while r.remaining() > 0:
            hdr = isoff.parse_box_header(r)
            if hdr is None:
                break
            fourcc, _, header_size, size = hdr
            current = fourcc
            if fourcc == b"moof":
                payload = r.sub(min(size - header_size, r.remaining()))
                self.moof = isoff.parse_moof(
                    payload.data[payload.pos:payload.end])
                if self.moof is None:
                    return False
            elif fourcc == b"mdat":
                break
            else:
                if r.remaining() < size - header_size:
                    break
                r.skip(size - header_size)
        if current != b"mdat" or self.moof is None \
                or not self.moof.traf:
            return False
        traf = self.moof.traf[0]
        if traf.tfxd is None or traf.tfrf is None:
            return False
        self.finished = True
        return True


def stream_parse_fragment(stream: MssStream, data: bytes) -> bool:
    """gst_mss_stream_parse_fragment (gstmssmanifest.c:1632-1682):
    for live streams, grow the fragment list from the fragment's tfrf
    look-ahead entries (only entries newer than the current tail)."""
    if not stream.has_live_fragments:
        return False
    parser = MssFragmentParser()
    if not parser.add_buffer(data):
        return False
    traf = parser.moof.traf[0]
    added = False
    for entry in traf.tfrf.entries:
        if not stream.fragments:
            break
        last = stream.fragments[-1]
        if last.time >= entry.time:
            continue
        stream.fragments.append(Fragment(number=last.number + 1,
                                         repetitions=1,
                                         time=entry.time,
                                         duration=entry.duration))
        added = True
    return added
