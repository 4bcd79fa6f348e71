"""capture_s: host seconds of this run's `capture.capture`: the captured
run's warm-up step and its CUDA-graph capture (set-up; none on the CPU,
where the steps run eagerly)."""
from benchmark.metrics._spans import setup_s


def read(r):
    return setup_s(r, "capture.capture")
