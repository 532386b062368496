"""Declarative scenario runner (utils/validate.py) — the gst-validate
.validatetest + flow-expectations analog (SURVEY §4.2; reference
tests/validate/opencv/cvtracker.validatetest).  First run records the
expectations (committed fixtures); every later run compares
line-for-line."""

import glob
import os

import pytest

from gstbad.utils.validate import (parse_validatetest,
                                       run_validatetest)

HERE = os.path.join(os.path.dirname(__file__), "validate")
TESTS = sorted(glob.glob(os.path.join(HERE, "*.validatetest")))


def test_parse_format():
    with open(TESTS[0]) as f:
        t = parse_validatetest(f.read())
    assert "videotestsrc" in t.launch or "audiotestsrc" in t.launch
    assert t.flows and t.flows[0].pad
    assert any(a == "run" for a, _ in t.actions)


@pytest.mark.parametrize("path", TESTS, ids=[
    os.path.splitext(os.path.basename(p))[0] for p in TESTS])
def test_validate_scenario(path):
    report = run_validatetest(path)
    assert report.ok, "\n".join(report.details)
    # flows recorded content
    for name, lines in report.flows.items():
        assert lines and lines[0].startswith("event caps:")
        assert any(ln.startswith("buffer:") for ln in lines)
    if report.recorded:
        pytest.skip(f"recorded expectations: {report.recorded} "
                    "(first run — rerun to compare)")


def test_validate_detects_flow_divergence(tmp_path):
    """A changed pipeline must FAIL against the recorded expectation."""
    src = os.path.join(HERE, "zebrastripe.validatetest")
    with open(src) as f:
        text = f.read()
    t = tmp_path / "z.validatetest"
    t.write_text(text)
    r1 = run_validatetest(str(t))          # records
    assert r1.recorded
    t.write_text(text.replace("threshold=90", "threshold=10"))
    r2 = run_validatetest(str(t))
    assert not r2.ok
    assert any("differs" in d for d in r2.details)


def test_validate_expect_message_failure():
    """expect-message on a never-posted message reports a failure."""
    from gstbad.utils.validate import ValidateTest, FlowConfig
    t = ValidateTest(
        launch="videotestsrc width=32 height=32 format=GRAY8 ! fakesink",
        flows=[],
        actions=[("run", {"n-frames": "8", "window": "8"}),
                 ("expect-message", {"element": "nosuch",
                                     "name": "Never"})])
    r = run_validatetest(t)
    assert not r.ok and "expect-message failed" in r.details[0]
