#!/usr/bin/env python3
"""Extract the Siren7 (ITU-T G.722.1) codebook DATA tables from the
reference header into gstbad/data/siren_tables.py.

These are trained/standardized codebook constants (huffman code and
bitcount tables, quantizer centroids, noise fill levels, differential
decoder trees) defined by the G.722.1 codec — pure DATA, extracted
verbatim with provenance (like data/fist.xml and the coloreffects GIMP
curves; see data/README.md).  The codec ENGINE that consumes them
(gstbad/io/siren.py) is this repo's own transcription.

Source: /root/reference/gst/siren/huffman_consts.h
"""

from __future__ import annotations

import os
import re

SRC = "/root/reference/gst/siren/huffman_consts.h"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "gstbad", "data", "siren_tables.py")

WANT = [
    ("differential_region_power_bits", "int"),
    ("differential_region_power_codes", "int"),
    ("bitcount_table_category0", "int"),
    ("code_table_category0", "int"),
    ("bitcount_table_category1", "int"),
    ("code_table_category1", "int"),
    ("bitcount_table_category2", "int"),
    ("code_table_category2", "int"),
    ("bitcount_table_category3", "int"),
    ("code_table_category3", "int"),
    ("bitcount_table_category4", "int"),
    ("code_table_category4", "int"),
    ("bitcount_table_category5", "int"),
    ("code_table_category5", "int"),
    ("bitcount_table_category6", "int"),
    ("code_table_category6", "int"),
    ("differential_decoder_tree", "int"),
    ("mlt_quant", "float"),
    ("decoder_tree0", "int"),
    ("decoder_tree1", "int"),
    ("decoder_tree2", "int"),
    ("decoder_tree3", "int"),
    ("decoder_tree4", "int"),
    ("decoder_tree5", "int"),
    ("decoder_tree6", "int"),
    ("noise_category5", "float"),
    ("noise_category6", "float"),
]


def parse_initializer(text: str, typ: str):
    """Parse a C brace initializer into nested Python lists."""
    text = text.strip()
    if not text.startswith("{"):
        return ((float if typ == "float" else int)
                (text.rstrip("fF") if typ == "float" else text, 0)
                if typ == "int" else float(text.rstrip("fF")))
    out = []
    depth = 0
    start = None
    buf = ""
    i = 0
    while i < len(text):
        c = text[i]
        if c == "{":
            depth += 1
            if depth == 2 and start is None:
                start = i
        elif c == "}":
            if depth == 2:
                out.append(parse_initializer(text[start:i + 1], typ))
                start = None
            depth -= 1
            if depth == 0:
                if buf.strip():
                    pass
                break
        elif depth == 1:
            buf += c
        i += 1
    if out:
        return out
    items = [s.strip() for s in buf.split(",") if s.strip()]
    if typ == "float":
        return [float(s.rstrip("fF")) for s in items]
    return [int(s, 0) for s in items]


def main():
    src = open(SRC).read()
    chunks = {}
    for name, typ in WANT:
        m = re.search(
            rf"static\s+(?:const\s+)?(?:int|float)\s+{name}\s*(?:\[[^\]]*\])+"
            rf"\s*=\s*", src)
        if not m:
            raise SystemExit(f"table {name} not found")
        # grab the balanced brace initializer
        i = src.index("{", m.end())
        depth = 0
        for j in range(i, len(src)):
            if src[j] == "{":
                depth += 1
            elif src[j] == "}":
                depth -= 1
                if depth == 0:
                    break
        chunks[name] = parse_initializer(src[i:j + 1], typ)

    m = re.search(r"noise_category7\s*=\s*([0-9.eEfF+-]+)\s*;", src)
    noise7 = float(m.group(1).rstrip("fF"))
    m = re.search(r"index_table\[8\]\s*=\s*\{([^}]*)\}", src)
    index_table = [int(s) for s in m.group(1).split(",")]

    with open(OUT, "w") as f:
        f.write('"""Siren7 / ITU-T G.722.1 codebook tables — extracted DATA '
                '(see data/README.md).\n\nGenerated by '
                'tools/gen_siren_tables.py from\n'
                'gst/siren/huffman_consts.h in the reference tree.  The '
                'codec engine that\nconsumes these lives in '
                'gstbad/io/siren.py.\n"""\n\n')
        f.write("# fmt: off\n")
        for name, _ in WANT:
            f.write(f"{name} = {chunks[name]!r}\n\n")
        f.write(f"noise_category7 = {noise7!r}\n\n")
        f.write(f"index_table = {index_table!r}\n")
        f.write("# fmt: on\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
