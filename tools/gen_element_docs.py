#!/usr/bin/env python3
"""Generate docs/elements.md from the element registry (the hotdoc analog)."""

import sys
import os
import sys
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import gstbad as gt
from gstbad.core.registry import get_class


def _register_dynamic_families():
    """The plugin-host families (LADSPA/frei0r/LV2) register from
    their fixture bundles so the reference documents them too."""
    try:
        from gstbad.io import ladspa as lio
        from gstbad.elements.audio.ladspa import \
            register_ladspa_elements
        register_ladspa_elements(lio.build_test_plugins())
    except Exception as e:  # noqa: BLE001
        print(f"note: ladspa fixtures unavailable ({e})")
    try:
        from gstbad.elements.video.frei0r import \
            register_frei0r_elements
        register_frei0r_elements(include_fixtures=True)
    except Exception as e:  # noqa: BLE001
        print(f"note: frei0r fixtures unavailable ({e})")
    try:
        from gstbad.io import lv2 as l2io
        from gstbad.elements.audio.lv2 import register_lv2_elements
        register_lv2_elements(l2io.build_test_plugins())
    except Exception as e:  # noqa: BLE001
        print(f"note: lv2 fixtures unavailable ({e})")


def main():
    _register_dynamic_families()
    lines = ["# Element reference",
             "",
             "Auto-generated by tools/gen_element_docs.py; "
             f"{len(gt.element_names())} elements.", ""]
    for name in gt.element_names():
        cls = get_class(name)
        doc = (cls.__doc__ or "").strip().split("\n\n")[0].replace("\n", " ")
        doc = " ".join(doc.split())
        lines.append(f"## {name}")
        lines.append("")
        lines.append(f"*kind: {cls.KIND}*"
                     + (f" — formats: {', '.join(cls.FORMATS)}"
                        if getattr(cls, "FORMATS", None) else ""))
        lines.append("")
        if doc:
            lines.append(doc)
            lines.append("")
        props = getattr(cls, "PROPERTIES", ())
        if props:
            lines.append("| property | type | default | range | notes |")
            lines.append("|---|---|---|---|---|")
            for p in props:
                rng = (f"{p.min}..{p.max}"
                       if p.min is not None or p.max is not None else "")
                notes = []
                if p.controllable:
                    notes.append("controllable")
                if p.static:
                    notes.append("static (re-prepares)")
                # defaults that are paths into the checkout print
                # relative to it, so the page does not depend on where
                # the repo lives
                default = str(p.default).replace(REPO + os.sep, "<repo>/")
                lines.append(f"| {p.name} | {p.type.__name__} | {default} "
                             f"| {rng} | {', '.join(notes)} |")
            lines.append("")
    with open("docs/elements.md", "w") as f:
        f.write("\n".join(lines))
    print(f"wrote docs/elements.md ({len(gt.element_names())} elements)")


if __name__ == "__main__":
    main()
