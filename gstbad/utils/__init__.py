from gstbad.utils.trace import PipelineTracer, trace_to
