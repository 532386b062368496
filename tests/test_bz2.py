"""bz2enc/bz2dec stream codecs (ext/bz2) — same libbz2 as the
reference via CPython's bz2 module."""

import bz2
import numpy as np

from gstbad.io import bz2stream


def test_stream_roundtrip_and_chunking():
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 8, 100000, np.uint8).tobytes()
    enc = bz2stream.Bz2Enc(block_size=6, buffer_size=1000)
    chunks = []
    for k in range(0, len(payload), 7777):
        chunks += enc.push(payload[k:k + 7777])
    chunks += enc.finish()
    assert all(len(c) == 1000 for c in chunks[:-1])
    stream = b"".join(chunks)
    # byte-identical to one-shot libbz2 at the same block size
    assert stream == bz2.compress(payload, 6)

    dec = bz2stream.Bz2Dec(first_buffer_size=128, buffer_size=4096)
    out = []
    for k in range(0, len(stream), 911):
        out += dec.push(stream[k:k + 911])
    out += dec.finish()
    assert len(out[0]) == 128          # first_buffer_size semantics
    assert all(len(c) == 4096 for c in out[1:-1])
    assert b"".join(out) == payload
    assert dec.eos


def test_block_size_changes_stream():
    data = bytes(range(256)) * 400
    a = bz2stream.compress(data, 1)
    b = bz2stream.compress(data, 9)
    assert a != b
    assert bz2stream.decompress(a) == data == bz2stream.decompress(b)
