#!/usr/bin/env python3
"""gstbad-launch — the gst-launch-1.0 analog.

    python tools/gstbad_launch.py -v --cpu \
        videotestsrc pattern=bars '!' solarize '!' fakesink
    python tools/gstbad_launch.py --cpu -n 30 -m \
        "videotestsrc ! coloreffects preset=sepia ! fakesink"
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gstbad.cli import launch_main

if __name__ == "__main__":
    sys.exit(launch_main())
