"""Build the JAX package's native libraries once per test run.

``mediastreamer2_tpu.native`` compiles ``_ms2io.so`` and ``_ms2rtp.so`` at
first use, through one fixed ``.tmp`` path each. Several test modules ask
for them while they are imported, so under pytest-xdist every worker starts
the same g++ at the same moment: the losers of the race find their ``.tmp``
already moved, fall back to the portable ``-O2`` flags, and overwrite the
``-march=native`` build. A worker that loads that library then runs the
SRTP edge without its AES-NI/SHA-NI/PCLMUL path, and
``test_hw_crypto_path_active_when_cpu_supports_it`` fails on it.

Each process therefore takes an exclusive lock on the library's directory
before collection: the first one compiles, the others find the finished
library and only load it.
"""
import fcntl
import os


def pytest_configure(config):
    from mediastreamer2_tpu import native

    fd = os.open(os.path.dirname(os.path.abspath(native.__file__)), os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        native.native_available()
        native.rtp_edge_available()
    finally:
        os.close(fd)
