"""The measurement entry points refuse to run without a GPU: no fallback
to the CPU or to the host, and no result line."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_fails_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / script)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout[-2000:]
    assert '"ok": true' not in r.stdout
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())
    assert "needs a GPU" in r.stderr, r.stderr[-2000:]
