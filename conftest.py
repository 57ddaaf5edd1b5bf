"""pytest configuration for every run in this repository: the CPU share of
each test process, the per-test time limit and the `slow` tests, all in
tests/run_limits.py."""

pytest_plugins = ["tests.run_limits"]
