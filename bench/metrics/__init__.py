"""One reader per per-layer metric, named as in ``BENCHMARK.json``.

``bench/metrics/<metric name>.py`` defines ``read(r)``, where ``r`` is the
run's :class:`bench.harness.Reading`; it returns the number, or None when
the run has nothing to read for it (the harness then leaves the metric out
of the line). The harness loads the file by its name.
"""
