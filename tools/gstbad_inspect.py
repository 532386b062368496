#!/usr/bin/env python3
"""gst-inspect-1.0 analog: list elements or show one element's details
(name, kind, formats, properties with types/ranges/defaults).

    python tools/gstbad_inspect.py              # list all elements
    python tools/gstbad_inspect.py gaussianblur # details for one element
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax


def main():
    jax.config.update("jax_platforms", "cpu")
    import gstbad as gt
    from gstbad.core.registry import get_class

    if len(sys.argv) < 2:
        names = gt.element_names()
        for name in names:
            cls = get_class(name)
            doc = (cls.__doc__ or "").strip().splitlines()
            print(f"{name:24s} {cls.KIND:12s} "
                  f"{doc[0][:70] if doc else ''}")
        print(f"\nTotal: {len(names)} elements")
        return
    name = sys.argv[1]
    cls = get_class(name)
    print(f"Factory details:\n  Name        {name}")
    print(f"  Kind        {cls.KIND}")
    print(f"  Class       {cls.__module__}.{cls.__name__}")
    fmts = getattr(cls, "FORMATS", None)
    if fmts:
        print(f"  Formats     {', '.join(fmts)}")
    if cls.__doc__:
        print("\nDescription:")
        for line in cls.__doc__.strip().splitlines():
            print(f"  {line.strip()}")
    props = getattr(cls, "PROPERTIES", ())
    if props:
        print("\nElement properties:")
        for p in props:
            rng = ""
            if p.min is not None or p.max is not None:
                rng = f" range [{p.min}, {p.max}]"
            flags = []
            if p.controllable:
                flags.append("controllable")
            if p.static:
                flags.append("static")
            fl = f" ({', '.join(flags)})" if flags else ""
            print(f"  {p.name:24s} {p.type.__name__:6s} "
                  f"default={p.default!r}{rng}{fl}")


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # e.g. `| head`
        pass
