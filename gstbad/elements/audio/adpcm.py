"""adpcmdec — IMA/DVI and Microsoft ADPCM audio decoder
(gst/adpcmdec/adpcmdec.c).

A real in-tree codec with pure per-sample compute (no external library):
4-bit codes expand through a predictor + adaptive step recurrence.  The
recurrence is sequential per channel but independent across blocks, so
the window decodes as ONE `lax.scan` over code positions vectorized over
[blocks, channels] (ops/audio.adpcm_ima_decode / adpcm_ms_decode) —
wall-clock scales with samples-per-block, not total samples.

Input: uint8 blocks [B, blocksize] (one ADPCM block per frame slot, the
reference's block-aligned chain, adpcmdec.c:398-454); push bytes through
`push_bytes` for host-source framing.  Output: interleaved S16.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require
from gstbad.ops import audio as ops


@register
class AdpcmDec(Element):
    NAME = "adpcmdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("layout", str, "dvi", static=True),  # dvi | microsoft
        Property("blocksize", int, 1024, 8, None, static=True),
        Property("rate", int, 44100, 1, None, static=True),
        Property("channels", int, 1, 1, 2, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._n = 0

    def negotiate(self, in_spec):
        require(self.props["layout"] in ("dvi", "microsoft"),
                f"adpcmdec: bad layout {self.props['layout']!r} "
                "(want dvi or microsoft)")
        bs, ch = self.props["blocksize"], self.props["channels"]
        if self.props["layout"] == "dvi":
            require(bs >= 4 * ch, "adpcmdec: blocksize < dvi header")
            self._n_samples = (bs - 4 * ch) * 2 + ch
            # the code region must form whole 8-sample-per-channel groups
            require((self._n_samples - ch) % (8 * ch) == 0,
                    "adpcmdec: blocksize not group-aligned for dvi")
        else:
            require(bs >= 7 * ch, "adpcmdec: blocksize < ms header")
            self._n_samples = (bs - 7 * ch) * 2 + 2 * ch
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=self.props["rate"], channels=ch)

    def push_bytes(self, data: bytes) -> None:
        self._buf += data

    def pull_window(self, window: int):
        bs = self.props["blocksize"]
        n = min(len(self._buf) // bs, window)
        if n == 0:
            return None
        blocks = np.frombuffer(self._buf[: n * bs],
                               np.uint8).reshape(n, bs)
        self._buf = self._buf[n * bs:]
        # _n_samples counts interleaved samples across channels (the
        # reference's outsize count); duration is per-channel samples
        dur = (self._n_samples // self.props["channels"]
               ) * 1_000_000_000 // self.props["rate"]
        pts = (self._n + np.arange(n, dtype=np.int64)) * dur
        self._n += n
        return FrameBatch.make(jnp.asarray(blocks),
                               pts=jnp.asarray(pts))

    def process(self, params, state, batch: FrameBatch):
        ch = self.props["channels"]
        if self.props["layout"] == "dvi":
            out = ops.adpcm_ima_decode(batch.data, ch)
        else:
            out = ops.adpcm_ms_decode(batch.data, ch)
        return state, batch.with_data(out)


@register
class AdpcmEnc(Element):
    """adpcmenc (gst/adpcmenc/adpcmenc.c): DVI/IMA ADPCM encoder.

    S16 blocks of samples-per-block in, uint8 ADPCM blocks out;
    step_index carries across blocks (adpcmenc.c 'enc->step_index'),
    prev_sample resets to each block's header sample.  Encoding is one
    scan over the window's flattened samples (ops/audio.adpcm_ima_encode)
    with the nibble/byte packing as pure reshapes."""

    NAME = "adpcmenc"
    PROPERTIES = (
        Property("layout", str, "dvi", static=True),
        Property("blocksize", int, 1024, 8, 8192, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(self.props["layout"] == "dvi",
                "adpcmenc: only the dvi layout exists in the reference")
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16,
                "adpcmenc: needs S16 audio")
        ch = in_spec.channels
        bs = self.props["blocksize"]
        require((bs - 4 * ch) % (4 * ch) == 0,
                f"adpcmenc: blocksize {bs} not group-aligned "
                f"for {ch} channels")
        self._groups = (bs - 4 * ch) // (4 * ch)
        self._n_samples = 1 + 8 * self._groups
        self._channels = ch
        return MediaSpec(kind="bytes", format="adpcm-dvi",
                         rate=in_spec.rate, channels=ch)

    def init_state(self, batch: int):
        return jnp.zeros((self._channels,), jnp.int32)

    def process(self, params, state, batch: FrameBatch):
        b, s, ch = batch.data.shape
        require(s == self._n_samples,
                f"adpcmenc: need exactly {self._n_samples} samples per "
                f"block, got {s} (feed through audiobuffersplit)")
        codes, header_si, state = ops.adpcm_ima_encode(batch.data, state)
        # header: sample0 (LE int16) + step_index + 0, per channel
        s0 = batch.data[:, 0, :].astype(jnp.int32) & 0xFFFF
        hdr = jnp.stack([s0 & 0xFF, (s0 >> 8) & 0xFF,
                         header_si, jnp.zeros_like(s0)],
                        axis=-1)                       # [B, C, 4]
        hdr = hdr.reshape(b, 4 * ch)
        # body: per group, per channel, 4 bytes of (low | high<<4) pairs
        body = codes[:, 1:, :].reshape(b, self._groups, 8, ch)
        lo, hi = body[:, :, 0::2, :], body[:, :, 1::2, :]
        byts = (lo & 0x0F) | ((hi << 4) & 0xF0)        # [B, G, 4, C]
        byts = jnp.moveaxis(byts, 3, 2).reshape(b, self._groups * ch * 4)
        out = jnp.concatenate([hdr, byts], axis=1).astype(jnp.uint8)
        return state, batch.with_data(out)
