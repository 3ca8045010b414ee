"""The benchmark harness of ``hybrid_rag_colbertv2_tpu_torch``.

Everything here is the yardstick: the seeded generators of weights,
corpora and traffic (``gen``), the frozen operation and byte counts and
the table of peaks (``yardstick``), the plain reference and the
comparison that decides ``correct`` (``reference``, ``compare``), the
reduction of profiler traces (``devtrace``) and the drive of the system
under test (``serve``). Only ``serve`` imports the port.
"""
