from qtpu_torch.bench.results import BenchmarkResult  # noqa: F401
from qtpu_torch.bench.runner import QuantizationBenchmark  # noqa: F401
