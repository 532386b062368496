#!/usr/bin/env python3
"""Extract the coloreffects preset LUTs from the reference C source.

The five 768-byte lookup tables (gst/coloreffects/gstcoloreffects.c:117-339)
are curve data produced in GIMP, not code; functional parity requires the
identical bytes.  This tool parses the C octal-escaped string literals and
emits them as base64 into _coloreffects_tables.py.
"""

import base64
import re
import sys

SRC = "/root/reference/gst/coloreffects/gstcoloreffects.c"
OUT = "gstbad/elements/video/_coloreffects_tables.py"

TABLES = ["sepia_table", "heat_table", "xray_table", "xpro_table",
          "yellowblue_table"]


def parse_c_string_concat(text: str) -> bytes:
    """Decode a sequence of concatenated C string literals."""
    out = bytearray()
    for lit in re.findall(r'"((?:[^"\\]|\\.)*)"', text, re.S):
        i = 0
        while i < len(lit):
            c = lit[i]
            if c != "\\":
                out.append(ord(c))
                i += 1
                continue
            i += 1
            c = lit[i]
            if c in "01234567":
                j = i
                while j < len(lit) and j < i + 3 and lit[j] in "01234567":
                    j += 1
                out.append(int(lit[i:j], 8))
                i = j
            elif c == "x":
                j = i + 1
                while j < len(lit) and lit[j] in "0123456789abcdefABCDEF":
                    j += 1
                out.append(int(lit[i + 1:j], 16))
                i = j
            else:
                esc = {"n": 10, "t": 9, "r": 13, "\\": 92, '"': 34, "'": 39,
                       "0": 0, "a": 7, "b": 8, "f": 12, "v": 11}
                out.append(esc[c])
                i += 1
    return bytes(out)


def extract_initializer(src: str, name: str) -> str:
    """Return the initializer text up to the terminating `;` outside quotes."""
    m = re.search(rf"static const guint8 {name}\[768\]\s*=", src)
    if not m:
        sys.exit(f"table {name} not found")
    i = m.end()
    in_str = False
    start = i
    while i < len(src):
        c = src[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == ";":
            return src[start:i]
        i += 1
    sys.exit(f"unterminated initializer for {name}")


def main():
    src = open(SRC).read()
    chunks = []
    for name in TABLES:
        data = parse_c_string_concat(extract_initializer(src, name))
        assert len(data) == 768, (name, len(data))
        chunks.append((name, data))
    with open(OUT, "w") as f:
        f.write('"""coloreffects preset LUTs.\n\n'
                "Byte-identical curve data extracted from the reference\n"
                "(gst/coloreffects/gstcoloreffects.c:117-339) by\n"
                "tools/extract_luts.py.  Each table is 256 RGB triples.\n"
                '"""\n\nimport base64\nimport numpy as np\n\n')
        for name, data in chunks:
            b64 = base64.b64encode(data).decode()
            f.write(f"{name.upper()} = np.frombuffer(base64.b64decode(\n")
            for i in range(0, len(b64), 72):
                f.write(f'    "{b64[i:i+72]}"\n')
            f.write("), dtype=np.uint8).reshape(256, 3)\n\n")
        f.write("TABLES = {\n")
        for name, _ in chunks:
            preset = name.replace("_table", "")
            f.write(f'    "{preset}": {name.upper()},\n')
        f.write("}\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
