"""pytest configuration for every run in this repository: the CPU share of
each test process, the per-test time limit and the `slow` tests, all in
tests/run_limits.py; and the benchmark's tiny cut of the boot
configuration (hebench/tests/tiny_boot.py)."""

# hebench/tests/tiny_boot.py registers the boot configuration's tiny cut in
# hebench/tests/tiny.py's TINY, which every hebench test file's make_root
# reads, on import: loaded here so that any one of those files runs alone
pytest_plugins = ["tests.run_limits", "hebench.tests.tiny_boot"]
