"""LV2 element family (ext/lv2/gstlv2{,filter,source}.c) over the
io/lv2.py host.

Like the reference, element types are REGISTERED DYNAMICALLY from the
bundles on LV2_PATH, named from the plugin URI with the protocol cut
off and non-[A-Za-z0-9-+] canonicalized to '-' (gstlv2.c:187-193).
The reference's shape gate is kept (lv2_plugin_discover,
gstlv2.c:200-222): plugins with no audio ports are skipped; zero
audio-ins make a source only when there is exactly ONE output group;
zero audio-outs (sinks) are skipped with the reference's FIXME; and
filters need exactly one input and one output group — a pg:group'd
stereo pair counts once (lv2_count_ports, gstlv2.c:122-160).
Properties come from control/CV input ports with the reference's
param-name canonicalization (gstlv2utils.c:560-595); output control
ports read back live (the peak-meter pattern).

Since this environment ships no system LV2 bundles, the default scan
registers the in-repo fixture bundle (native/lv2_plugins.c + .ttl)
when its directory is on LV2_PATH; register_lv2_elements() can be
called with an explicit path.

Element API (host-source family, like elements/audio/ladspa.py):
  - filters: chain(block) with block [n, ch_in] float32 ->
    [n, ch_out] (gstlv2filter.c transform);
  - sources: create(samples) -> [samples, ch] with plugin-kept phase
    (gstlv2source.c fill; samplesperbuffer default 1024).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from gstbad.core.element import Element, Property
from gstbad.core.registry import register
from gstbad.io import lv2 as lv2_io

DEFAULT_RATE = 44100
DEFAULT_SAMPLES_PER_BUFFER = 1024  # gstlv2source.c default


class _Lv2Base(Element):
    PLUGIN: lv2_io.Lv2Plugin = None
    KIND = "host-source"

    def __init__(self, **props):
        self.rate = int(props.pop("rate", DEFAULT_RATE))
        self._instance = self.PLUGIN.instantiate(self.rate)
        super().__init__(**props)

    # route property access through the live control ports so output
    # controls (meters) read back current values
    def set_property(self, name: str, value) -> None:
        key = name.replace("_", "-")
        if key in self._propspecs:
            super().set_property(key, value)
            self._instance.set_control(key, self.props[key])
            return
        raise KeyError(f"{self.NAME}: no property {name!r} "
                       f"(has {sorted(self._propspecs)})")

    def get_property(self, name: str):
        key = name.replace("_", "-")
        try:
            return self._instance.get_control(key)
        except lv2_io.Lv2Error:
            return super().get_property(key)

    def close(self) -> None:
        self._instance.close()

    # GstPreset analog (gst_lv2_load_preset, gstlv2utils.c:256-272):
    # restore control-port values by symbol onto the mapped properties
    def get_preset_names(self):
        return sorted(self.PLUGIN.presets)

    def load_preset(self, name: str) -> bool:
        vals = self.PLUGIN.presets.get(name)
        state = self.PLUGIN.preset_state.get(name)
        if vals is None and state is None:
            return False
        sym_to_prop = {s.port.symbol: s for s in self.PLUGIN.in_props}
        for sym, value in (vals or {}).items():
            spec = sym_to_prop.get(sym)
            if spec is None:
                continue        # "Preset port '%s' is missing" warning
            if spec.type is bool:
                value = value > 0.5
            elif spec.type is int:
                value = int(value)
            self.set_property(spec.name, value)
        if state:
            # the lilv_state_restore non-port half: binary/atom
            # properties through the plugin's LV2_State_Interface (r5)
            self._instance.restore_state(state)
        return True


class _Lv2Filter(_Lv2Base):
    def chain(self, block) -> np.ndarray:
        block = np.asarray(block, np.float32)
        if block.ndim == 1:
            block = block[:, None]
        return self._instance.run(block.shape[0], block)


class _Lv2Source(_Lv2Base):
    def create(self, samples: int = DEFAULT_SAMPLES_PER_BUFFER
               ) -> np.ndarray:
        return self._instance.run(samples)


def _make_element_class(plugin: lv2_io.Lv2Plugin):
    n_in, n_out = plugin.audio_group_counts()
    if n_in == 0 and n_out == 0:
        return None                     # "has no audio pads"
    if n_in == 0:
        if n_out != 1:
            return None                 # "is not a GstBaseSrc"
        base = _Lv2Source
    elif n_out == 0:
        return None                     # "is a sink element" (FIXME)
    elif n_in != 1 or n_out != 1:
        return None                     # "is not a GstAudioFilter"
    else:
        base = _Lv2Filter
    props = []
    for spec in plugin.in_props:
        props.append(Property(spec.name, spec.type, spec.default,
                              spec.minimum, spec.maximum,
                              doc=spec.nick))
    cls = type(f"Lv2_{plugin.element_name}", (base,), {
        "NAME": plugin.element_name,
        "PLUGIN": plugin,
        "PROPERTIES": tuple(props),
        "__doc__": f"{plugin.name} (LV2 <{plugin.uri}> from "
                   f"{os.path.basename(plugin.bundle)})",
    })
    return cls


def register_lv2_elements(path: Optional[str] = None) -> List[str]:
    """Scan and register; returns the new element names.  Plugins
    whose element name is already registered are skipped (the
    reference's g_type_from_name drop, gstlv2.c:196-198)."""
    from gstbad.core import registry
    names = []
    for plugin in lv2_io.scan(path):
        if plugin.element_name in registry.element_names():
            continue
        cls = _make_element_class(plugin)
        if cls is None:
            continue
        register(cls)
        names.append(plugin.element_name)
    return names


# default scan, like the reference plugin's cached-data path walk.  A bad
# bundle anywhere on LV2_PATH must degrade to a skipped plugin, never to an
# ImportError of the whole package (ADVICE r4).
if os.environ.get("LV2_PATH"):
    try:
        register_lv2_elements()
    except Exception as _e:  # noqa: BLE001 - import-time plugin scan
        import warnings
        warnings.warn(f"LV2 plugin scan failed; continuing without "
                      f"dynamic LV2 elements: {_e}")
