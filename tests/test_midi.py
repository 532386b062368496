"""SMF parsing (gst/midi/midiparse.c) — hand-built files."""

import pytest

from gstbad.io import midi


def _vlq(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _smf(tracks, fmt=1, division=480):
    out = b"MThd" + (6).to_bytes(4, "big") + fmt.to_bytes(2, "big") \
        + len(tracks).to_bytes(2, "big") + division.to_bytes(2, "big")
    for t in tracks:
        out += b"MTrk" + len(t).to_bytes(4, "big") + t
    return out


def test_notes_running_status_and_tempo():
    # track: note-on ch0 @pulse 0, running-status note-on @480,
    # tempo change to 250000 @480, note-off @960, EOT
    t1 = (_vlq(0) + bytes([0x90, 60, 100])
          + _vlq(480) + bytes([62, 100])           # running status
          + _vlq(480) + bytes([0x80, 60, 0])
          + _vlq(0) + bytes([0xFF, 0x2F, 0x00]))
    t2 = (_vlq(480) + bytes([0xFF, 0x51, 0x03]) + (250000).to_bytes(3, "big")
          + _vlq(0) + bytes([0xFF, 0x2F, 0x00]))
    events = midi.parse_midi(_smf([t1, t2]))
    notes = [e for e in events if e.event in (0x90, 0x80)]
    assert [(e.event, e.data[0]) for e in notes] == \
        [(0x90, 60), (0x90, 62), (0x80, 60)]
    # pulse 0 at t=0; pulse 480 still at the default tempo when track 1's
    # event fires... the scheduler processes all events AT pulse 480 with
    # whatever tempo is current as they are handled; after the tempo
    # meta, later positions use the new tempo: pulse 960 * 250000us/480
    assert notes[0].time_ns == 0
    assert notes[2].pulse == 960
    assert notes[2].time_ns == 960 * 1000 * 250000 // 480
    # the absolute-rescale quirk (midiparse.c:1141): NOT an integrated
    # timeline
    assert notes[2].time_ns == 500_000_000


def test_format0_single_track_and_ticks():
    t = (_vlq(0) + bytes([0xC0, 5])                 # program change (len 1)
         + _vlq(960) + bytes([0x90, 64, 80])
         + _vlq(0) + bytes([0xFF, 0x2F, 0x00]))
    events = midi.parse_midi(_smf([t], fmt=0), emit_ticks=True)
    progs = [e for e in events if e.event == 0xC0]
    assert progs[0].data == bytes([5])
    ticks = [e for e in events if e.event == 0xF9]
    # note at pulse 960 -> 1.0 s at default tempo; 10ms ticks in between
    assert len(ticks) == 99
    assert ticks[0].time_ns == 10_000_000


def test_invalid_files_rejected():
    with pytest.raises(ValueError):
        midi.parse_midi(b"JUNK")
    with pytest.raises(ValueError):
        midi.parse_midi(_smf([b""], division=0x8000))  # SMPTE division
