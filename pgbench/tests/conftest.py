"""The benchmark's own tests (python -m pytest pgbench/tests -q, from the
repository's root).  Tests marked ``cuda`` need an NVIDIA card and skip
without one; each decides inside the test, never at import."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card and nvcc; skips without one")
