"""festival element + wire protocol (gst/festival) against a mock
server speaking the exact festival protocol."""

import socket
import struct
import threading

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline
from gstbad.io import festival as fest


def make_wav(samples, rate=16000):
    pcm = np.asarray(samples, np.int16).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate,
                                 rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


def stuff(data):
    """Festival server side of the key protocol: the 11-char literal
    prefix is transmitted with a stuffed X; the bare key terminates."""
    return data.replace(b"ft_StUfF_ke", b"ft_StUfF_keX") \
        + b"ft_StUfF_key"


class MockFestival(threading.Thread):
    """Accepts one connection; answers Parameter.set with LP + OK and
    every tts_textall with WV <stuffed wav> OK.  Records commands."""

    def __init__(self, wav):
        super().__init__(daemon=True)
        self.wav = wav
        self.commands = []
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]

    def run(self):
        conn, _ = self._srv.accept()
        f = conn.makefile("rb")
        try:
            while True:
                line = f.readline()
                if not line:
                    break
                self.commands.append(line.decode().strip())
                if b"Parameter.set" in line:
                    conn.sendall(b"LP\n" + stuff(b"nil\n")
                                 + b"OK\n")
                elif b"tts_textall" in line:
                    conn.sendall(b"WV\n" + stuff(self.wav)
                                 + b"OK\n")
        finally:
            conn.close()
            self._srv.close()


def test_protocol_roundtrip_and_escaping():
    t = np.arange(3200)
    wav = make_wav((np.sin(t / 10.0) * 9000).astype(np.int16))
    srv = MockFestival(wav)
    srv.start()
    client = fest.FestivalClient(host="127.0.0.1", port=srv.port)
    waves = client.talk('say "hello" \\ world')
    client.close()
    assert waves == [wav]                      # unstuffed exactly
    # the reference's escaping: quotes and backslashes get a backslash
    tts = [c for c in srv.commands if "tts_textall" in c][0]
    assert '\\"hello\\"' in tts and "\\\\" in tts
    assert tts.endswith('"fundamental")')


def test_stuffed_key_in_payload():
    """A waveform CONTAINING the stuff key round-trips (the X-stuffing
    branch of socket_receive_file_to_buff)."""
    payload = b"AAAAft_StUfF_keyBBBBft_StUfF_kCCCC"
    wav = make_wav(np.zeros(8, np.int16))
    body = wav + payload
    srv = MockFestival(body)
    srv.start()
    client = fest.FestivalClient(host="127.0.0.1", port=srv.port)
    waves = client.talk("x")
    client.close()
    assert waves == [body]


def test_festival_element_synthesizes_audio():
    rate = 16000
    t = np.arange(6400)
    wav = make_wav((np.sin(t / 8.0) * 8000).astype(np.int16), rate)
    srv = MockFestival(wav)
    srv.start()
    el = gt.make("festival", host="127.0.0.1", port=srv.port,
                 samplesperbuffer=800)
    el.push_text("hello world")
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    spec = el.out_spec
    assert (spec.kind, spec.format, spec.rate) == ("audio", "S16",
                                                   rate)
    assert el.wav_packets == [wav]
    outs = pipe.run(n_frames=8)
    pcm = np.concatenate([np.asarray(o.data) for o in outs])
    flat = pcm.reshape(-1)[:6400]
    ref = (np.sin(t / 8.0) * 8000).astype(np.int16)
    assert np.array_equal(flat, ref)


def test_connection_refused_raises():
    with pytest.raises(fest.FestivalError):
        fest.FestivalClient(host="127.0.0.1", port=1)
