"""freeverb (gst/freeverb/gstfreeverb.c) — Schroeder/Moorer reverb."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import AudioFilter, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require
from gstbad.ops import audio as ops


@register
class Freeverb(AudioFilter):
    """room-size/damping/width/level all default per the reference
    (gstfreeverb.c:403-421); mono or stereo in, stereo out; S16 or F32."""

    NAME = "freeverb"
    FORMATS = (AudioFormat.F32, AudioFormat.S16)
    CHANNELS = (1, 2)
    PROPERTIES = (
        Property("room-size", float, 0.5, 0.0, 1.0, controllable=True),
        Property("damping", float, 0.2, 0.0, 1.0, controllable=True),
        Property("width", float, 1.0, 0.0, 1.0, controllable=True),
        Property("level", float, 0.5, 0.0, 1.0, controllable=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        # output is always stereo (gstfreeverb.c:612-621 transform_caps)
        return spec.with_(channels=2)

    def dynamic_params(self):
        # property -> model coefficients (gstfreeverb.c:536-570), f32 like C
        rs = np.float32(self.props["room-size"])
        damping = np.float32(self.props["damping"])
        width = np.float32(self.props["width"])
        level = np.float32(self.props["level"])
        wet = np.float32(level * np.float32(1.0))
        return {
            "feedback": jnp.float32(np.float32(rs * np.float32(0.28))
                                    + np.float32(0.7)),
            "damp1": jnp.float32(damping),
            "damp2": jnp.float32(np.float32(1) - damping),
            "wet1": jnp.float32(wet * (width / np.float32(2)
                                       + np.float32(0.5))),
            "wet2": jnp.float32(wet * ((np.float32(1) - width)
                                       / np.float32(2))),
            "dry": jnp.float32(np.float32(1.0 - self.props["level"])
                               * np.float32(1.0)),
            "gain": jnp.float32(0.015),
        }

    def init_state(self, batch: int):
        return ops.freeverb_init_state(self.in_spec.rate)

    def process(self, params, state, batch: FrameBatch):
        x = batch.data
        b, s = x.shape[0], x.shape[1]
        mono = self.in_spec.channels == 1
        is_int = self.in_spec.format == AudioFormat.S16
        flat = x.reshape((b * s,) if mono else (b * s, 2))
        xf = flat.astype(jnp.float32)
        state, y = ops.freeverb_process(state, xf, params,
                                        self.in_spec.rate, mono)
        if is_int:
            y = jnp.clip(y, -32768.0, 32767.0).astype(jnp.int16)
        out = y.reshape(b, s, 2)
        return state, batch.with_data(out)
