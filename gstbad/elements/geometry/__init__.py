from gstbad.elements.geometry import geometrictransform  # noqa: F401
