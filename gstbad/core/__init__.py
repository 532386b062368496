from gstbad.core.spec import MediaSpec, VideoFormat, AudioFormat, BayerFormat
from gstbad.core.element import Element, VideoFilter, AudioFilter, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register, make, element_names
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.core.harness import Harness
from gstbad.core.bus import Bus, Message
