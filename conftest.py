"""Session set-up for every pytest run in this repository.

The JAX package's data path loads ``native/librangeproj.so``, which its
``data/native.py`` builds with ``make -C native`` at first use, writing the
library in place.  Under pytest-xdist every worker would run that build at
once while collecting (``tests/test_native.py`` asks for the library at
import), and a worker that opened a half-written file would go without the
library for its whole session.  So the library is built here, once, before
any collection: ``pytest_configure`` runs in the xdist controller before it
starts the workers, and a lock file in ``build/`` keeps concurrent pytest
runs from building it together.  Nothing is built when the file is
present, and a failed build leaves the package to find the library
missing, as it would without this file.
"""

import fcntl
import pathlib
import subprocess

REPO = pathlib.Path(__file__).resolve().parent
NATIVE = REPO / "native"


def pytest_configure(config):
    library = NATIVE / "librangeproj.so"
    if library.exists():
        return
    lock = REPO / "build" / "librangeproj.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if not library.exists():
            try:
                subprocess.run(["make", "-C", str(NATIVE)], capture_output=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired):
                pass
