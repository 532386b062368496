"""Declarative scenario runner — the gst-validate `.validatetest` analog
(SURVEY §4.2; reference example
tests/validate/opencv/cvtracker.validatetest + its
flow-expectations/log-tracker-src-expected recording).

Test file format (the reference's shape):

    meta,
        args = {
            "videotestsrc pattern=ball ... ! zebrastripe name=z ! fakesink",
        },
        configs = {
            "$(validateflow), pad=z, record-buffers=true, buffers-checksum=true",
        }
    run, n-frames=30, window=10
    set-property, element-name=z, property=threshold, value=40
    run, n-frames=10, window=10
    expect-message, element=pipeline-or-element, name=message-name
    eos

Actions (the subset of gst-validate's scenario actions this framework
can express): `run` (the crank-clock analog — produce frames),
`set-property` (live property change), `seek` (restart sources at a
position), `eos` (drain), `expect-message` (assert a bus message was
posted).

Each `$(validateflow)` config taps the named element's output and
writes a flow log — `event caps:` then one `buffer:` line per frame
with pts/dur (+ md5 checksum with buffers-checksum=true).  The log is
compared line-for-line against `flow-expectations/log-<pad>-expected`
next to the test file; running with record=True (or when no expectation
exists yet) writes the recording instead — gst-validate's own
record-then-compare workflow.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

NSEC = 1_000_000_000


def _fmt_time(ns: int) -> str:
    """0:00:00.033333333 — GST_TIME_FORMAT."""
    s, rem = divmod(int(ns), NSEC)
    h, s2 = divmod(s, 3600)
    m, s3 = divmod(s2, 60)
    return f"{h}:{m:02d}:{s3:02d}.{rem:09d}"


@dataclasses.dataclass
class FlowConfig:
    pad: str
    record_buffers: bool = True
    buffers_checksum: bool = False


@dataclasses.dataclass
class ValidateTest:
    launch: str
    flows: List[FlowConfig]
    actions: List[Tuple[str, Dict[str, str]]]
    path: Optional[str] = None


def parse_validatetest(text: str, path: Optional[str] = None
                       ) -> ValidateTest:
    """Parse the meta block + action lines."""
    launch = None
    flows: List[FlowConfig] = []
    actions: List[Tuple[str, Dict[str, str]]] = []

    # pull the quoted strings out of args = { ... } / configs = { ... }
    m = re.search(r"args\s*=\s*\{(.*?)\}", text, re.DOTALL)
    if not m:
        raise ValueError("validatetest: no args block")
    args_strings = re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(1))
    if not args_strings:
        raise ValueError("validatetest: empty args block")
    launch = args_strings[0]

    m = re.search(r"configs\s*=\s*\{(.*?)\}", text, re.DOTALL)
    if m:
        for cfg in re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(1)):
            if "$(validateflow)" not in cfg:
                continue
            fields = dict(
                kv.split("=", 1) for kv in
                (p.strip() for p in cfg.split(",")[1:]) if "=" in kv)
            flows.append(FlowConfig(
                pad=fields.get("pad", "").split(":")[0],
                record_buffers=fields.get("record-buffers",
                                          "true") == "true",
                buffers_checksum=fields.get("buffers-checksum",
                                            "false") == "true"))

    # action lines follow the meta block (which ends at the configs'
    # closing brace or the args' when no configs)
    tail = text[text.rindex("}") + 1:] if "}" in text else text
    for line in tail.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(",")]
        fields = dict(p.split("=", 1) for p in parts[1:] if "=" in p)
        actions.append((parts[0], fields))
    return ValidateTest(launch=launch, flows=flows, actions=actions,
                        path=path)


def _frame_bytes(batch, i: int) -> bytes:
    d = batch.data
    if isinstance(d, dict):
        return b"".join(np.ascontiguousarray(np.asarray(v)[i]).tobytes()
                        for k, v in sorted(d.items()))
    return np.ascontiguousarray(np.asarray(d)[i]).tobytes()


class _FlowLog:
    def __init__(self, cfg: FlowConfig):
        self.cfg = cfg
        self.lines: List[str] = []
        self._caps_logged = False

    def log_caps(self, spec) -> None:
        if not self._caps_logged:
            self.lines.append(f"event caps: {spec};")
            self._caps_logged = True

    def log_batch(self, batch, dur_ns: int) -> None:
        if not self.cfg.record_buffers:
            return
        pts = np.asarray(batch.pts)
        valid = np.asarray(batch.valid)
        for i in range(batch.batch):
            if not valid[i]:
                continue
            line = (f"buffer: pts={_fmt_time(int(pts[i]))}, "
                    f"dur={_fmt_time(dur_ns)}")
            if self.cfg.buffers_checksum:
                md5 = hashlib.md5(_frame_bytes(batch, i)).hexdigest()
                line += f", checksum={md5}"
            self.lines.append(line)


@dataclasses.dataclass
class ValidateReport:
    ok: bool
    details: List[str]
    flows: Dict[str, List[str]]
    recorded: List[str]


def run_validatetest(path_or_test, record: bool = False
                     ) -> ValidateReport:
    """Execute a .validatetest: run the pipeline through the scenario
    actions, tap the configured pads, and compare (or record) the flow
    expectations."""
    import jax

    from gstbad.core.pipeline import parse_launch

    if isinstance(path_or_test, ValidateTest):
        test = path_or_test
    else:
        with open(path_or_test) as f:
            test = parse_validatetest(f.read(), path=str(path_or_test))

    pipeline = parse_launch(test.launch)
    pipeline.negotiate()
    taps = [f.pad for f in test.flows]
    logs = {f.pad: _FlowLog(f) for f in test.flows}
    details: List[str] = []
    ok = True

    def node_spec(name):
        for n in pipeline._order or pipeline.nodes:
            if n.name == name or n.element.NAME == name:
                return n.element.out_spec
        raise KeyError(f"validate: no element {name!r}")

    window = 8
    compiled_window = None

    def run_frames(n: int, w: int) -> None:
        nonlocal compiled_window
        if compiled_window != w:
            pipeline.compile(w, taps=taps)
            compiled_window = w
        params = pipeline.params()
        states = pipeline._states
        done = 0
        while done < n:
            states, leaf_batches, messages = pipeline._step(
                params, states, None)
            pipeline._drain_messages(
                leaf_batches[len(pipeline._leaves()) - 1], messages)
            tapped = pipeline.taps_of(leaf_batches)
            for name, batch in tapped.items():
                spec = node_spec(name)
                dur = (spec.frame_duration_ns if spec.kind == "video"
                       else NSEC // 30)
                nb = jax.tree_util.tree_map(
                    lambda x: np.asarray(x), batch)
                logs[name].log_caps(spec)
                logs[name].log_batch(nb, dur)
            done += w
        pipeline._states = states

    for action, fields in test.actions:
        if action == "run":
            w = int(fields.get("window", window))
            run_frames(int(fields.get("n-frames", w)), w)
        elif action == "set-property":
            pipeline.set_static_property(
                fields["element-name"], fields["property"],
                fields["value"])
            compiled_window = None        # recompile with the change
        elif action == "seek":
            # flush + reposition counter sources (the Play seek path)
            pipeline._states = None
            compiled_window = None
        elif action == "eos":
            pipeline.send_eos()
        elif action == "expect-message":
            msgs = pipeline.bus.pop(
                element=fields.get("element"),
                name=fields.get("name"))
            want_field = {k: v for k, v in fields.items()
                          if k not in ("element", "name")}
            found = [m for m in msgs
                     if all(str(m.fields.get(k)) == v
                            for k, v in want_field.items())]
            if not found:
                ok = False
                details.append(
                    f"expect-message failed: {fields} "
                    f"(bus has {len(pipeline.bus.messages)} messages)")
        elif action in ("stop", "crank-clock"):
            pass                           # crank-clock: run drives time
        else:
            ok = False
            details.append(f"unknown action {action!r}")

    # flow-expectation compare / record
    recorded: List[str] = []
    flows = {name: log.lines for name, log in logs.items()}
    if test.path is not None:
        exp_dir = os.path.join(
            os.path.dirname(test.path),
            os.path.splitext(os.path.basename(test.path))[0],
            "flow-expectations")
        for name, lines in flows.items():
            exp_path = os.path.join(exp_dir, f"log-{name}-expected")
            if record or not os.path.exists(exp_path):
                os.makedirs(exp_dir, exist_ok=True)
                with open(exp_path, "w") as f:
                    f.write("\n".join(lines) + "\n")
                recorded.append(exp_path)
                continue
            with open(exp_path) as f:
                expected = f.read().splitlines()
            if expected != lines:
                ok = False
                for i, (e, g) in enumerate(zip(expected, lines)):
                    if e != g:
                        details.append(
                            f"{name}: line {i + 1} differs\n"
                            f"  expected: {e}\n  got:      {g}")
                        break
                if len(expected) != len(lines):
                    details.append(
                        f"{name}: {len(expected)} expected lines, "
                        f"{len(lines)} recorded")
    return ValidateReport(ok=ok, details=details, flows=flows,
                          recorded=recorded)
