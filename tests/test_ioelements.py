"""Element facades over io-layer codecs: aesenc/aesdec, id3mux,
pnmenc/pnmdec, aiffparse, autovideoconvert (registry parity with the
reference element names)."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.spec import MediaSpec
from gstbad.io import aiff as aiff_io

KEY = "1f9423681beb9a79215820f6bda73d0f"
IV = "e9aa8e834d8d70b7e0d254ff670dd718"


def test_aes_elements_roundtrip():
    enc = gt.make("aesenc", key=KEY, iv=IV)
    dec = gt.make("aesdec", key=KEY, iv=IV)
    pt = b"the quick brown fox jumps over the lazy dog"
    ct = enc.chain(pt) + enc.finish()
    assert ct != pt and len(ct) % 16 == 0
    assert dec.chain(ct) + dec.finish() == pt


def test_aes_serialize_iv():
    enc = gt.make("aesenc", key=KEY, iv=IV,
                  **{"serialize-iv": True})
    dec = gt.make("aesdec", key=KEY, iv=IV,
                  **{"serialize-iv": True})
    ct = enc.chain(b"payload bytes") + enc.finish()
    assert ct[:16] == bytes.fromhex(IV)  # iv rides in-band
    assert dec.chain(ct) + dec.finish() == b"payload bytes"


def test_id3mux_element():
    mux = gt.make("id3mux", **{"write-v1": True})
    mux.set_tags(title="Title", artist="Artist")
    mux.chain(b"AUDIO")
    blob = mux.finish()
    assert blob[:3] == b"ID3"
    assert blob[-128:-125] == b"TAG"
    assert b"AUDIO" in blob


def test_pnm_elements_roundtrip():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (12, 16, 3), np.uint8)
    doc = gt.make("pnmenc").chain(rgb)
    assert doc.startswith(b"P6")
    dec = gt.make("pnmdec")
    back = dec.chain(doc)
    assert np.array_equal(back, rgb)
    assert dec.src_caps["width"] == 16
    gray = rng.integers(0, 256, (12, 16), np.uint8)
    doc = gt.make("pnmenc").chain(gray)
    assert doc.startswith(b"P5")
    assert np.array_equal(gt.make("pnmdec").chain(doc), gray)


def test_aiffparse_element(tmp_path):
    p = tmp_path / "t.aiff"
    samples = (np.sin(np.linspace(0, 40, 2205))[:, None]
               * 12000).astype(np.int16)
    aiff_io.write_aiff(str(p), MediaSpec(kind="audio", format="S16BE",
                                         rate=22050, channels=1),
                       samples)
    el = gt.make("aiffparse")
    data = p.read_bytes()
    el.chain(data[:100])
    el.chain(data[100:])
    out = el.finish()
    assert out["caps"]["rate"] == 22050
    assert out["caps"]["channels"] == 1
    assert np.array_equal(out["data"], samples)


def test_autovideoconvert_negotiates():
    el = gt.make("autovideoconvert")
    spec = MediaSpec(kind="video", format="I420", width=32, height=24)
    out = el.set_info(spec)
    assert out.kind == "video"
