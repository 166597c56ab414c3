"""The benchmark's own code: manifest lookup, traffic, the run, the trace
reduction and the comparison that decides ``correct``.

Everything that belongs to one configuration, one traffic mix or one
metric lives in files of its own under ``bench/configs``,
``bench/workloads`` and ``bench/metrics``; this package finds them by the
names in ``BENCHMARK.json``.
"""
