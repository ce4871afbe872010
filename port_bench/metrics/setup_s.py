"""Seconds from the start of the process to the first timed unit of work:
imports, the kernel library (built, or loaded from the build cache), weights,
corpus, calibration and warm-up."""


def read(reading):
    return reading.setup_s if reading.setup_s > 0 else None
