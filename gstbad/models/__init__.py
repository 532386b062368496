from gstbad.models.benchmarks import BENCHMARKS, build
