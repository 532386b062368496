#!/usr/bin/env python3
"""gst-element-maker analog (tools/gst-element-maker +
tools/element-templates/ in the reference): scaffold a new element module
plus its golden transcription stub and test file.

    python tools/element_maker.py myeffect --base videofilter
    python tools/element_maker.py mygate   --base audiofilter
"""

import argparse
import os

ELEMENT_TPL = '''\
"""{name} — <one-line purpose> (<reference file:line>)."""

from __future__ import annotations

import jax.numpy as jnp

from gstbad.core.element import Property, {base_cls}
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import {fmt_cls}, MediaSpec


@register
class {cls}({base_cls}):
    """<transcribe the reference's math here, citing file:line>."""

    NAME = "{name}"
    FORMATS = ({fmt_example},)
    PROPERTIES = (
        Property("example-prop", float, 1.0, 0.0, 10.0, controllable=True),
    )

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        # hot loop goes here; keep it a pure jittable function
        return state, batch.with_data(data)
'''

TEST_TPL = '''\
"""Fidelity: {name} vs golden."""

import numpy as np

from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec


def test_{pyname}_matches_golden(rng):
    h = Harness("{name}")
    # h.set_src_spec(...)
    # got = h.push_pull(x)
    # np.testing.assert_array_equal(got, golden(...))
    raise NotImplementedError("transcribe the C hot loop into golden/ "
                              "and assert against it")
'''

BASES = {
    "videofilter": ("VideoFilter", "VideoFormat", "VideoFormat.AYUV",
                    "gstbad/elements/video"),
    "audiofilter": ("AudioFilter", "AudioFormat", "AudioFormat.F32",
                    "gstbad/elements/audio"),
    "element": ("Element", "VideoFormat", "VideoFormat.AYUV",
                "gstbad/elements"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--base", choices=sorted(BASES), default="videofilter")
    args = ap.parse_args()
    name = args.name.lower()
    pyname = name.replace("-", "_")
    cls = "".join(w.capitalize() for w in pyname.split("_"))
    base_cls, fmt_cls, fmt_example, pkg = BASES[args.base]

    el_path = os.path.join(pkg, f"{pyname}.py")
    test_path = os.path.join("tests", f"test_{pyname}.py")
    for path, tpl in ((el_path, ELEMENT_TPL), (test_path, TEST_TPL)):
        if os.path.exists(path):
            raise SystemExit(f"refusing to overwrite {path}")
    with open(el_path, "w") as f:
        f.write(ELEMENT_TPL.format(name=name, cls=cls, base_cls=base_cls,
                                   fmt_cls=fmt_cls,
                                   fmt_example=fmt_example))
    with open(test_path, "w") as f:
        f.write(TEST_TPL.format(name=name, pyname=pyname))
    init = os.path.join(pkg, "__init__.py")
    with open(init, "a") as f:
        f.write(f"from {pkg.replace(os.sep, '.')} import {pyname}"
                "  # noqa: F401\n")
    print(f"wrote {el_path}, {test_path}; registered in {init}.")
    print("Next: transcribe the reference math into gstbad/golden/ "
          "with file:line citations, then make the test bit-exact.")


if __name__ == "__main__":
    main()
