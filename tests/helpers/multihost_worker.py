"""Two-process jax.distributed worker (tests/test_multihost_2proc.py).

Each process owns 4 virtual CPU devices; the pair forms one 8-device
dp mesh.  Process 0 drives the ipcpipeline CONTROL plane (state change +
a window-descriptor event + a tiny metadata buffer) to process 1, then
both collectively assemble the global window with
parallel.multihost.feed_window (the DCN data plane) and run one jitted
pipeline step over the global mesh.  Each process dumps a digest of its
addressable output shards for the parent test to verify against the
single-process reference.

Usage: multihost_worker.py <pid> <port> <outdir> <ipc_name>
"""

import hashlib
import json
import os
import sys
import time

pid = int(sys.argv[1])
port = sys.argv[2]
outdir = sys.argv[3]
ipc_name = sys.argv[4]

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gstbad as gt  # noqa: E402
from gstbad.core.frame import FrameBatch  # noqa: E402
from gstbad.core.spec import MediaSpec  # noqa: E402
from gstbad.io.ipcpipeline import (IpcMaster, IpcSlave,  # noqa: E402
                                       STATE_CHANGE_SUCCESS)
from gstbad.parallel import make_mesh  # noqa: E402
from gstbad.parallel.multihost import feed_window  # noqa: E402

H, W, B_LOCAL = 16, 128, 4
window_info = {}

# -- control plane (io/ipcpipeline.py typed chunks over the shm ring) -------
if pid == 0:
    master = IpcMaster(ipc_name, slot_size=1 << 20, n_slots=4)
    # let the slave open the rings before the first chunk
    time.sleep(1.0)
    master.send_event({"type": "window", "pts0": 0, "window": 2 * B_LOCAL})
    assert master.set_state("playing",
                            timeout_ms=120000) == STATE_CHANGE_SUCCESS
    meta = FrameBatch.make(np.zeros((1, 4), np.uint8),
                           pts=np.zeros(1, np.int64))
    master.push_buffer(meta, MediaSpec(kind="bytes", format="window-desc"))
else:
    deadline = time.time() + 120
    slave = None
    while slave is None:
        try:
            slave = IpcSlave(ipc_name,
                             on_event=lambda e: window_info.update(e))
        except FileNotFoundError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)
    got = slave.pull_buffer(120000)
    assert got is not None, "control buffer never arrived"
    assert window_info.get("type") == "window", window_info
    assert slave.state == "playing"

# -- data plane: collective global window assembly --------------------------
mesh = make_mesh(dp=8, sp=1, devices=jax.devices())
rng = np.random.default_rng(100 + pid)
local = rng.integers(0, 256, (B_LOCAL, H, W, 4), dtype=np.uint8)
local_pts = (pid * B_LOCAL + np.arange(B_LOCAL, dtype=np.int64)) * 33_000_000

with mesh:
    batch = feed_window(mesh, local, local_pts)
    assert batch.data.shape == (2 * B_LOCAL, H, W, 4), batch.data.shape

    p = gt.parse_launch("burn ! solarize ! chromahold ! fakesink")
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=W, height=H))
    step = p.compile(2 * B_LOCAL, jit=True, donate_state=False)
    _, leaf, _ = step(p.params(), p.init_states(2 * B_LOCAL), batch)
    out = leaf[-1].data
    jax.block_until_ready(out)

shards = {}
for sh in out.addressable_shards:
    start = sh.index[0].start or 0
    shards[str(start)] = hashlib.sha256(
        np.ascontiguousarray(np.asarray(sh.data)).tobytes()).hexdigest()

with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
    json.dump({"shards": shards,
               "n_devices": jax.device_count(),
               "window_info": window_info if pid else None}, f)

if pid == 0:
    master.send_eos()
    master.close()
else:
    slave.close()
print(f"worker {pid} done", flush=True)
