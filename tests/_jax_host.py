"""The JAX package's native host library for the port's tests, built from
its own source with its own flags into a directory the test names, and
``ideepcolor_tpu.ops.host`` pointed at it: a test holds the port's host
runtime against JAX's without building into the JAX package."""

import subprocess

from ideepcolor_tpu.ops import host as jhost


def use_jax_native(mp, directory):
    """Build JAX's library into ``directory`` and make ``jhost`` load it;
    ``mp`` (a pytest MonkeyPatch) restores the module's state."""
    out = directory / "libhostops.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                    "-fPIC", jhost._SRC, "-o", str(out)], check=True,
                   capture_output=True, timeout=300)
    mp.setattr(jhost, "_LIB", str(out))
    mp.setattr(jhost, "_lib", None)
    mp.setattr(jhost, "_build_failed", False)
    assert jhost.get_lib() is not None
    return jhost
