"""ccv_tpu's siphash signatures in every test worker.

ccv_tpu builds its native library (ccv_tpu/native/libccv_tpu_native.so) at
first use, and ``ccv_tpu.core.cache`` tries to load it once, when it is
imported. Test workers that import it at the same moment all run ``make``
on the same file; one that finds the library half-written fails to load it,
and its ``cache._siphash`` stays None, so that process signs with blake2b
while the port signs with siphash. ``siphash_signatures`` waits for the
library (a concurrent build ends in seconds), fails if it never loads, and
where the import lost the race points ``cache._siphash`` at the library's
siphash for as long as the fixture lives.
"""

import time
from contextlib import contextmanager

import pytest

from ccv_tpu.core import cache as jcache
from ccv_tpu.core import native as jnative

_WAIT_S = 180.0  # a cold build of the library takes well under this


def _load_native():
    """ccv_tpu's native library, retried while another process builds it;
    None if it never loads."""
    deadline = time.monotonic() + _WAIT_S
    while True:
        try:
            lib = jnative.load()
        except OSError:  # found half-written: another process is linking it
            lib = None
        if lib is not None or time.monotonic() > deadline:
            return lib
        time.sleep(0.5)


@contextmanager
def siphash_signatures():
    """ccv_tpu signs with siphash inside the block, whichever process won
    the build race."""
    assert _load_native() is not None, "ccv_tpu's native library did not load"
    with pytest.MonkeyPatch.context() as mp:
        if jcache._siphash is None:
            mp.setattr(jcache, "_siphash", jnative.siphash24)
        yield
