"""Element families.  Importing this package registers every element."""

from gstbad.elements import debugutils  # noqa: F401
from gstbad.elements import sources  # noqa: F401
from gstbad.elements import video  # noqa: F401
from gstbad.elements import geometry  # noqa: F401
from gstbad.elements import audio  # noqa: F401
from gstbad.elements import analysis  # noqa: F401
from gstbad.elements import observability  # noqa: F401
from gstbad.elements import bridges  # noqa: F401
from gstbad.io import shm as _shm_elements  # noqa: F401
from gstbad.io import ipcpipeline as _ipc_elements  # noqa: F401
from gstbad.elements import misc  # noqa: F401
from gstbad.elements import jaxfilter  # noqa: F401
from gstbad.elements import cv  # noqa: F401
from gstbad.elements import files  # noqa: F401
from gstbad.elements import kate  # noqa: F401
from gstbad.elements import pcap  # noqa: F401
from gstbad.elements import mpegts  # noqa: F401
from gstbad.elements import videoparsers  # noqa: F401
from gstbad.elements import jpegformat  # noqa: F401
from gstbad.elements import adaptivedemux  # noqa: F401
from gstbad.elements import ioelements  # noqa: F401
from gstbad.elements import asfmux  # noqa: F401
from gstbad.elements import mxf  # noqa: F401
from gstbad.elements import onvif  # noqa: F401
from gstbad.elements.audio import visualizers  # noqa: F401
from gstbad.elements import rfbsrc  # noqa: F401
from gstbad.elements import rtp  # noqa: F401
from gstbad.elements import sdpdemux  # noqa: F401
