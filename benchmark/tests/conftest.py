"""CPU tests of the benchmark. A test that needs a CUDA card carries the
repository's ``cuda`` marker and decides inside the test whether to skip."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
