"""Repo-wide pytest hooks, applied after ``tests/conftest.py`` has set up JAX.

``tests/conftest.py`` turns on JAX's persistent compilation cache. On
jaxlib 0.9.0, an XLA:CPU executable with cross-device collectives that is
loaded back from that cache can deadlock in its rendezvous on the 8-device
virtual mesh (``test_parallel.py``: the all-reduce and the collective permute
of the ring-sharded train step wait on each other until XLA aborts the
process). A freshly compiled executable runs fine, so test processes compile
in memory only and never read or write the on-disk cache.
"""


def pytest_configure(config):
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
