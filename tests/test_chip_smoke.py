"""chip_smoke.py must refuse to report anywhere but on a GPU: on the CPU it
exits non-zero and prints no result line, and alone (without the package)
it fails too."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
