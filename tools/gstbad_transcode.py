#!/usr/bin/env python3
"""gstbad-transcode — the gst-transcoder CLI analog (tools/gst-transcoder.c).

    python tools/gstbad_transcode.py in.y4m out.y4m \
        --filters "videoconvert format=AYUV ! gaussianblur sigma=2 \
                   ! videoconvert format=I420"
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gstbad.cli import transcode_main

if __name__ == "__main__":
    sys.exit(transcode_main())
