"""frei0r element family (gst/frei0r/gstfrei0r{,filter,src,mixer}.c)
over the io/frei0r.py host.

Like the reference, element types are REGISTERED DYNAMICALLY from the
plugins found on FREI0R_PATH: "frei0r-filter-<name>" /
"frei0r-src-<name>" / "frei0r-mixer-<name>" with the name lowercased
and non-[a-z0-9-+] canonicalized to '-'
(gstfrei0rfilter.c:269-294 register).

Properties mirror gst_frei0r_klass_install_properties
(gstfrei0r.c:60-230): BOOL -> bool, DOUBLE -> double [0,1],
STRING -> str, COLOR -> three float props <name>-r/-g/-b,
POSITION -> two double props <name>-x and <name>-Y — the capital 'Y'
reproduces the reference's own g_strconcat(prop_name, "-Y") quirk
(gstfrei0r.c:209), kept faithfully and lowercased on lookup since our
property table is case-preserving.

Since no system frei0r plugins ship in this environment, the in-repo
fixtures (native/frei0r_plugins.c) register by default — the
native/ladspa_plugins.c pattern.

Element API (host plugin family, like elements/audio/ladspa.py):
  - filters: transform(frames [B,H,W,4] u8, times) -> [B,H,W,4]
  - sources: create(n_frames, width, height, t0, fps) -> [B,H,W,4]
  - mixers:  mix(a, b[, c], times) -> [B,H,W,4]
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np

from gstbad.core.element import Element, Property
from gstbad.core.registry import register
from gstbad.io import frei0r as f0r_io


def _canon(name: str) -> str:
    """g_ascii_strdown + g_strcanon(A-Za-z0-9-+, '-')."""
    out = name.lower()
    return re.sub(r"[^a-z0-9\-+]", "-", out)


def _prop_name(param_name: str) -> str:
    n = _canon(param_name)
    if not n or not n[0].isalpha():
        n = "param-" + n  # gstfrei0r.c:83-90 glib argname fix
    return n


def _param_properties(plugin: f0r_io.Frei0rPlugin) -> List[Property]:
    props: List[Property] = []
    for i, (p, default) in enumerate(zip(plugin.params,
                                         plugin.defaults)):
        base = _prop_name(p.name)
        doc = p.explanation or p.name
        if p.type == f0r_io.PARAM_BOOL:
            props.append(Property(base, bool, bool(default),
                                  static=True, doc=doc))
        elif p.type == f0r_io.PARAM_DOUBLE:
            d = default if 0.0 <= default <= 1.0 else 0.0
            props.append(Property(base, float, d, 0.0, 1.0,
                                  static=True, doc=doc))
        elif p.type == f0r_io.PARAM_STRING:
            props.append(Property(base, str, default, static=True,
                                  doc=doc))
        elif p.type == f0r_io.PARAM_COLOR:
            for k, ch in enumerate("rgb"):
                d = default[k] if 0.0 <= default[k] <= 1.0 else 0.0
                props.append(Property(f"{base}-{ch}", float, d,
                                      0.0, 1.0, static=True,
                                      doc=f"{doc} ({ch.upper()})"))
        elif p.type == f0r_io.PARAM_POSITION:
            for k, ax in enumerate(("x", "Y")):
                # '-Y' reproduces gstfrei0r.c:209's capital-Y quirk;
                # our property table lowercases on set/get anyway
                d = default[k] if 0.0 <= default[k] <= 1.0 else 0.0
                props.append(Property(f"{base}-{ax.lower()}", float,
                                      d, 0.0, 1.0, static=True,
                                      doc=f"{doc} ({ax.upper()})"))
    return props


class _Frei0rBase(Element):
    PLUGIN: f0r_io.Frei0rPlugin = None
    KIND = "host-source"

    def __init__(self, width: int = 320, height: int = 240, **props):
        self.width = int(props.pop("width", width))
        self.height = int(props.pop("height", height))
        self._instance = self.PLUGIN.instantiate(self.width,
                                                 self.height)
        super().__init__(**props)
        self._sync_all_params()

    # -------- property <-> f0r param marshalling

    def _sync_all_params(self) -> None:
        for i in range(len(self.PLUGIN.params)):
            self._push_param(i)

    def _push_param(self, index: int) -> None:
        p = self.PLUGIN.params[index]
        base = _prop_name(p.name)
        if p.type in (f0r_io.PARAM_BOOL, f0r_io.PARAM_DOUBLE):
            self._instance.set_param(index, float(self.props[base]))
        elif p.type == f0r_io.PARAM_STRING:
            self._instance.set_param(index, self.props[base])
        elif p.type == f0r_io.PARAM_COLOR:
            self._instance.set_param(index, tuple(
                self.props[f"{base}-{ch}"] for ch in "rgb"))
        elif p.type == f0r_io.PARAM_POSITION:
            self._instance.set_param(index, (
                self.props[f"{base}-x"], self.props[f"{base}-y"]))

    def set_property(self, name: str, value) -> None:
        super().set_property(name, value)
        key = name.replace("_", "-").lower()
        for i, p in enumerate(self.PLUGIN.params):
            base = _prop_name(p.name)
            if key == base or key.startswith(base + "-"):
                self._push_param(i)
                return

    def read_param(self, name: str):
        """Read back through f0r_get_param_value (the reference's
        get_property path, gstfrei0r.c:290-390)."""
        key = name.replace("_", "-").lower()
        for i, p in enumerate(self.PLUGIN.params):
            if _prop_name(p.name) == key:
                return self._instance.get_param(i)
        raise KeyError(name)

    def process(self, params, state, batch):
        return state, batch


def _times(n: int, t0: float, fps: float) -> List[float]:
    return [t0 + k / fps for k in range(n)]


class _Frei0rFilter(_Frei0rBase):
    def transform(self, frames: np.ndarray, t0: float = 0.0,
                  fps: float = 30.0) -> np.ndarray:
        """[B,H,W,4] u8 -> [B,H,W,4] through f0r_update."""
        frames = np.asarray(frames, np.uint8)
        out = np.empty_like(frames)
        for k, t in enumerate(_times(len(frames), t0, fps)):
            out[k] = self._instance.update(t, frames[k])
        return out


class _Frei0rSrc(_Frei0rBase):
    def create(self, n_frames: int, t0: float = 0.0,
               fps: float = 30.0) -> np.ndarray:
        out = np.empty((n_frames, self.height, self.width, 4),
                       np.uint8)
        for k, t in enumerate(_times(n_frames, t0, fps)):
            out[k] = self._instance.update(t, None)
        return out


class _Frei0rMixer(_Frei0rBase):
    def mix(self, a: np.ndarray, b: np.ndarray,
            c: Optional[np.ndarray] = None, t0: float = 0.0,
            fps: float = 30.0) -> np.ndarray:
        a = np.asarray(a, np.uint8)
        b = np.asarray(b, np.uint8)
        out = np.empty_like(a)
        for k, t in enumerate(_times(len(a), t0, fps)):
            out[k] = self._instance.update2(
                t, a[k], b[k], None if c is None else c[k])
        return out


_REGISTERED: Dict[str, type] = {}


def register_frei0r_elements(paths: Optional[List[str]] = None,
                             include_fixtures: bool = True) \
        -> Dict[str, type]:
    """Scan and register one element type per plugin
    (gstfrei0r.c:603-709 register_plugins)."""
    scan_paths = list(paths) if paths else None
    if include_fixtures:
        fixture_dir = f0r_io.build_fixture_plugins()
        if scan_paths is None:
            env = os.environ.get("FREI0R_PATH")
            scan_paths = env.split(":") if env else []
        scan_paths.append(fixture_dir)
    new: Dict[str, type] = {}
    for plugin in f0r_io.scan(scan_paths):
        t = plugin.info.plugin_type
        if t == f0r_io.PLUGIN_TYPE_FILTER:
            prefix, base = "frei0r-filter-", _Frei0rFilter
        elif t == f0r_io.PLUGIN_TYPE_SOURCE:
            prefix, base = "frei0r-src-", _Frei0rSrc
        elif t in (f0r_io.PLUGIN_TYPE_MIXER2,
                   f0r_io.PLUGIN_TYPE_MIXER3):
            prefix, base = "frei0r-mixer-", _Frei0rMixer
        else:
            continue
        name = prefix + _canon(plugin.name)
        if name in _REGISTERED:
            new[name] = _REGISTERED[name]
            continue
        cls = type(
            f"Frei0r_{_canon(plugin.name).replace('-', '_')}",
            (base,),
            {"NAME": name, "PLUGIN": plugin,
             "PROPERTIES": tuple(_param_properties(plugin)),
             "__doc__": plugin.info.explanation})
        register(cls)
        _REGISTERED[name] = cls
        new[name] = cls
    return new


# default scan, like the LADSPA family: only when the user points
# FREI0R_PATH somewhere (building fixture .so's is explicit opt-in)
if os.environ.get("FREI0R_PATH"):
    register_frei0r_elements(include_fixtures=False)
