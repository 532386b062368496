"""ctypes bindings for the native shm ring (native/shmring.cpp) and the
shmsink/shmsrc elements — the sys/shm + sys/ipcpipeline analog.

Frames cross the process boundary as GDP packets (io/gdp.py) through a
POSIX shared-memory ring with semaphore backpressure, mirroring the
reference's ack'd chunk protocol (sys/ipcpipeline/protocol.txt).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.io import gdp

_LIB = None
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "shmring.cpp")


def _so_path() -> str:
    """Content-hash-named build artifact: always built from the checked-in
    source, never a committed binary (a stale mtime on a fresh clone must
    not dlopen an unverifiable blob)."""
    import hashlib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_REPO, "native", "build", f"libshmring-{digest}.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _so_path()
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.check_call(
            ["g++", "-O2", "-shared", "-fPIC", "-o", so, _SRC, "-lpthread"])
    lib = ctypes.CDLL(so)
    lib.shmring_create.restype = ctypes.c_void_p
    lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                   ctypes.c_uint32]
    lib.shmring_open.restype = ctypes.c_void_p
    lib.shmring_open.argtypes = [ctypes.c_char_p]
    lib.shmring_write.restype = ctypes.c_int
    lib.shmring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
    lib.shmring_read.restype = ctypes.c_int64
    lib.shmring_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64, ctypes.c_int]
    lib.shmring_eos.restype = ctypes.c_int
    lib.shmring_eos.argtypes = [ctypes.c_void_p]
    lib.shmring_close.argtypes = [ctypes.c_void_p]
    lib.shmring_slot_size.restype = ctypes.c_uint32
    lib.shmring_slot_size.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class ShmRing:
    """Python view of one ring endpoint."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @classmethod
    def create(cls, name: str, slot_size: int, n_slots: int = 8) -> "ShmRing":
        lib = _load()
        h = lib.shmring_create(name.encode(), slot_size, n_slots)
        if not h:
            raise OSError(f"shmring_create({name!r}) failed")
        return cls(h, lib)

    @classmethod
    def open(cls, name: str) -> "ShmRing":
        lib = _load()
        h = lib.shmring_open(name.encode())
        if not h:
            raise OSError(f"shmring_open({name!r}) failed")
        return cls(h, lib)

    def write(self, blob: bytes) -> None:
        rc = self._lib.shmring_write(self._h, blob, len(blob))
        if rc == -1:
            raise ValueError(f"packet {len(blob)} bytes exceeds slot size")
        if rc != 0:
            raise OSError("shmring_write failed")

    def read(self, timeout_ms: int = -1) -> Optional[bytes]:
        cap = self._lib.shmring_slot_size(self._h)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.shmring_read(self._h, buf, cap, timeout_ms)
        if n == 0:
            return None  # EOS
        if n == -2:
            raise TimeoutError("shmring_read timed out")
        if n < 0:
            raise OSError(f"shmring_read failed ({n})")
        return buf.raw[:n]

    def eos(self) -> None:
        self._lib.shmring_eos(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.shmring_close(self._h)
            self._h = None


@register
class ShmSink(Element):
    """shmsink: serialize each window as a GDP packet into the shm ring."""

    NAME = "shmsink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (
        Property("socket-path", str, "gstbad-shm", static=True),
        Property("shm-size", int, 64 * 1024 * 1024, static=True),
        Property("num-slots", int, 8, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._ring: Optional[ShmRing] = None

    def prepare(self):
        if self._ring is None:
            # shm-size is the TOTAL shared-memory area, matching the
            # reference shmsink (gstshmsink.c:402-405); each of the
            # num-slots ring slots gets an equal share.
            total = self.props["shm-size"]
            slot = total // self.props["num-slots"]
            if slot <= 0:
                raise ValueError("shm-size smaller than num-slots")
            try:
                st = os.statvfs("/dev/shm")
                free = st.f_bavail * st.f_frsize
                if total > free:
                    raise OSError(
                        f"shmsink: shm-size {total} exceeds /dev/shm free "
                        f"space {free}; a sparse ftruncate would SIGBUS on "
                        "first write — lower shm-size or num-slots")
            except FileNotFoundError:
                pass
            self._ring = ShmRing.create(self.props["socket-path"],
                                        slot, self.props["num-slots"])

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        self._ring.write(gdp.pay(np_batch, self.out_spec))

    def eos(self) -> None:
        if self._ring:
            self._ring.eos()


@register
class ShmSrc(Element):
    """shmsrc: pull GDP packets from the ring as a host source."""

    NAME = "shmsrc"
    KIND = "host-source"
    PROPERTIES = (
        Property("socket-path", str, "gstbad-shm", static=True),
        Property("timeout-ms", int, 5000, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._ring: Optional[ShmRing] = None
        self._spec = None

    def negotiate(self, in_spec):
        if self._ring is None:
            self._ring = ShmRing.open(self.props["socket-path"])
        # peek one packet to learn the spec (caps-over-the-wire analog)
        blob = self._ring.read(self.props["timeout-ms"])
        if blob is None:
            raise EOFError("shmsrc: EOS before first packet")
        self._pending, self._spec = gdp.depay(blob)
        return self._spec

    def pull_window(self, window: int) -> Optional[FrameBatch]:
        import jax
        if getattr(self, "_pending", None) is not None:
            batch, self._pending = self._pending, None
            return batch
        blob = self._ring.read(self.props["timeout-ms"])
        if blob is None:
            return None
        batch, _ = gdp.depay(blob)
        return batch

    def process(self, params, state, batch):
        return state, batch
