"""gmedec / openmptdec (ext/gme, ext/openmpt) over the real
libgme/libopenmpt bindings, driven with synthesized VGM / ProTracker
MOD fixtures (real bitstreams, real emulation)."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline
from gstbad.io import gme as gme_io
from gstbad.io import openmpt as mpt_io


def make_vgm(seconds=1):
    """Minimal VGM 1.50 stream: one SN76489 tone + volume, N frames
    of 735-sample waits, end."""
    n_waits = 60 * seconds
    cmds = bytes([0x50, 0x8E, 0x50, 0x0D, 0x50, 0x90])
    cmds += bytes([0x62]) * n_waits + bytes([0x66])
    hdr = bytearray(0x40)
    hdr[0:4] = b"Vgm "
    struct.pack_into("<I", hdr, 0x04, 0x40 + len(cmds) - 4)
    struct.pack_into("<I", hdr, 0x08, 0x00000150)
    struct.pack_into("<I", hdr, 0x0C, 3579545)
    struct.pack_into("<I", hdr, 0x18, 735 * n_waits)
    struct.pack_into("<I", hdr, 0x24, 60)
    struct.pack_into("<H", hdr, 0x28, 0x0009)
    hdr[0x2A] = 16
    struct.pack_into("<I", hdr, 0x34, 0x0C)
    return bytes(hdr) + cmds


def make_mod(title=b"TESTSONG"):
    """Minimal ProTracker M.K. module: 1 pattern, one C-2 note on a
    32-word sine sample."""
    hdr = bytearray()
    hdr += title.ljust(20, b"\0")
    for s in range(31):
        name = f"sample{s}".encode().ljust(22, b"\0")
        if s == 0:
            length, vol, rep, replen = 32, 64, 0, 16
        else:
            length, vol, rep, replen = 0, 0, 0, 1
        hdr += name + struct.pack(">H", length) + bytes([0, vol]) \
            + struct.pack(">HH", rep, replen)
    hdr += bytes([1, 127]) + bytes([0]) + bytes(127)
    hdr += b"M.K."
    pat = bytearray(1024)
    period, sample = 428, 1
    pat[0] = (sample & 0xF0) | (period >> 8)
    pat[1] = period & 0xFF
    pat[2] = (sample & 0x0F) << 4
    smp = ((np.sin(np.arange(64) * 2 * np.pi / 16) * 100)
           .astype(np.int8)).tobytes()
    return bytes(hdr) + bytes(pat) + smp


@pytest.mark.skipif(not gme_io.available(), reason="no libgme")
def test_gmedec_element_decodes_vgm():
    el = gt.make("gmedec")
    el.push_packet(make_vgm())
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    spec = el.out_spec
    assert (spec.format, spec.rate, spec.channels) == ("S16", 32000, 2)
    outs = pipe.run(n_frames=8)
    pcm = np.concatenate([np.asarray(o.data) for o in outs])
    assert pcm.shape[1:] == (1600, 2) and pcm.dtype == np.int16
    # the PSG tone is audible
    assert np.abs(pcm[:4].astype(np.int32)).max() > 1000
    msgs = pipe.bus.pop(name="tags")
    assert msgs and msgs[0]["track-count"] == 1
    assert msgs[0]["duration"] == 1000 * 10 ** 6
    assert "Sega" in msgs[0].fields.get("system", "")


@pytest.mark.skipif(not gme_io.available(), reason="no libgme")
def test_gmedec_rejects_garbage():
    el = gt.make("gmedec")
    el.push_packet(b"definitely not a module")
    pipe = Pipeline([el, gt.make("fakesink")])
    with pytest.raises(Exception):
        pipe.negotiate(None)


@pytest.mark.skipif(not mpt_io.available(), reason="no libopenmpt")
def test_openmptdec_element_decodes_mod():
    el = gt.make("openmptdec")
    el.push_packet(make_mod())
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    spec = el.out_spec
    assert (spec.format, spec.rate, spec.channels) == ("F32", 48000, 2)
    outs = pipe.run(n_frames=8)
    pcm = np.concatenate([np.asarray(o.data) for o in outs])
    assert pcm.shape[1:] == (1024, 2) and pcm.dtype == np.float32
    assert float(np.abs(pcm[:4]).max()) > 0.05
    msgs = pipe.bus.pop(name="tags")
    assert msgs and msgs[0]["title"] == "TESTSONG"
    assert msgs[0]["num-subsongs"] == 1
    assert msgs[0]["duration"] > 10 ** 9


@pytest.mark.skipif(not mpt_io.available(), reason="no libopenmpt")
def test_openmptdec_render_params_take_effect():
    """stereo-separation 0 collapses the channels; master-gain
    changes the level (real render-param effect, not stored props)."""
    def run(**props):
        el = gt.make("openmptdec", **props)
        el.push_packet(make_mod())
        pipe = Pipeline([el, gt.make("fakesink")])
        pipe.negotiate(None)
        outs = pipe.run(n_frames=4)
        return np.concatenate([np.asarray(o.data) for o in outs])

    base = run()
    mono = run(**{"stereo-separation": 0})
    assert np.allclose(mono[..., 0], mono[..., 1])
    loud = run(**{"master-gain": 600})        # +6 dB
    assert float(np.abs(loud).max()) \
        > float(np.abs(base).max()) * 1.5


@pytest.mark.skipif(not mpt_io.available(), reason="no libopenmpt")
def test_openmptdec_s16_output():
    el = gt.make("openmptdec", format="S16", rate=44100)
    el.push_packet(make_mod())
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=2)
    pcm = np.concatenate([np.asarray(o.data) for o in outs])
    assert pcm.dtype == np.int16
    assert np.abs(pcm.astype(np.int32)).max() > 500


@pytest.mark.skipif(not mpt_io.available(), reason="no libopenmpt")
def test_openmptdec_feeds_audio_graph():
    """Module PCM flows through real downstream audio elements."""
    el = gt.make("openmptdec")
    el.push_packet(make_mod())
    pipe = Pipeline([el, gt.make("freeverb"), gt.make("fakesink")])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=2)
    pcm = np.concatenate([np.asarray(o.data) for o in outs])
    assert pcm.shape[1:] == (1024, 2)
    assert np.isfinite(pcm).all()


@pytest.mark.skipif(not gme_io.available(), reason="no libgme")
def test_gmedec_checkpoint_resume(tmp_path):
    """save_checkpoint/load_checkpoint resumes the EMULATOR (engine
    seek), not just the sample counter."""
    def fresh():
        el = gt.make("gmedec")
        el.push_packet(make_vgm(2))
        p = Pipeline([el, gt.make("fakesink")])
        p.negotiate(None)
        return p

    ref_p = fresh()
    ref = np.concatenate([np.asarray(o.data) for o in
                          ref_p.run(n_frames=8, window=4)])
    p1 = fresh()
    out1 = p1.run(n_frames=4, window=4)
    p1.save_checkpoint(tmp_path / "ck.pkl")
    p2 = fresh()
    p2.compile(4)
    p2.load_checkpoint(tmp_path / "ck.pkl")
    out2 = p2.run(n_frames=4, window=4)
    got = np.concatenate([np.asarray(o.data)
                          for o in out1 + out2])
    n = min(len(ref), len(got))
    np.testing.assert_array_equal(got[:n], ref[:n])


@pytest.mark.skipif(not mpt_io.available(), reason="no libopenmpt")
def test_openmptdec_checkpoint_resume(tmp_path):
    def fresh():
        el = gt.make("openmptdec")
        el.push_packet(make_mod())
        p = Pipeline([el, gt.make("fakesink")])
        p.negotiate(None)
        return p

    ref_p = fresh()
    ref = np.concatenate([np.asarray(o.data) for o in
                          ref_p.run(n_frames=8, window=4)])
    p1 = fresh()
    out1 = p1.run(n_frames=4, window=4)
    p1.save_checkpoint(tmp_path / "ck.pkl")
    p2 = fresh()
    p2.compile(4)
    p2.load_checkpoint(tmp_path / "ck.pkl")
    out2 = p2.run(n_frames=4, window=4)
    got = np.concatenate([np.asarray(o.data)
                          for o in out1 + out2])
    n = min(len(ref), len(got))
    # module render restart at a seeked position: sample-exact for
    # this single-pattern fixture
    np.testing.assert_allclose(got[:n], ref[:n], atol=1e-4)
