from gstbad.elements.analysis import compare  # noqa: F401
