from gstbad.elements.sources import testsrc  # noqa: F401
