from gstbad.session.play import (  # noqa: F401
    AudioInfo, MediaInfo, Play, PlayState, StreamInfo, SubtitleInfo,
    VideoInfo)
from gstbad.session.player import (  # noqa: F401
    DirectDispatcher, Player, QueuedDispatcher, SignalAdapter)
from gstbad.session.transcoder import Transcoder
from gstbad.session.camera import Camera  # noqa: F401
