"""Stateless-decoder base layer (gst-libs/gst/codecs).

The reference's GstH264Decoder/H265/VP9/VP8/AV1/MPEG2 base classes own
everything a stateless (hardware) decoder needs besides the pixel
math: POC computation, DPB storage/bumping, reference-list
construction, reference marking and output reordering.  Here each
family is a plain-Python state machine ("engine") over the io/
bitstream parsers; the pixel backend is pluggable (the device pipeline
feeds decoded planes from a real codec binding where one exists).
"""
