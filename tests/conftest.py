"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; sharding tests use XLA's host-platform
device-count override, which gives 8 independent CPU "devices" that
exercise the same jax.sharding/Mesh/collective code paths several cards
would.  The card itself is exercised by `python chip_smoke.py` (and
`--cards 4`).  A test that needs a card carries the `gpu` marker and
skips from inside the test or a fixture, never at import or collection
time, so every test worker collects the same tests.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# hermetic tests: no cross-test (or cross-run) panel-sketch cache hits;
# the cache itself is covered by an explicit tmpdir test
os.environ.setdefault("RKMH_TPU_PANEL_CACHE", "0")
# ... and no input-index entries for tmp-path test inputs in the real
# user cache (tests that exercise the index point it at a tmpdir)
os.environ.setdefault("RKMH_TPU_INPUT_INDEX", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import rkmh_tpu  # noqa: F401,E402  (enables x64 before tests import jax)
import jax  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()
assert len(jax.devices()) == 8, jax.devices()
