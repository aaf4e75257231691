"""What the harness and the reference load. Top-level module names are
compared whole: ``vcp_tpu_torch`` begins with ``vcp_tpu`` and is not it."""

import json
import os
import subprocess
import sys

from vcpbench import bench, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "vcp_tpu"}

_REPORT = (
    "import json, sys\n"
    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")


def _top_level(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + _REPORT],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax():
    """A whole CPU run of a cell, the program included."""
    mods = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "from vcpbench import bench\n"
        "if __name__ == '__main__':\n"
        "    r = bench.run_cell('nvenc-pan', 3, 0.1, True, device='cpu',\n"
        "                       size=(96, 64))\n"
        "    assert r is not None\n")
    assert "vcp_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "import vcpbench.check, vcpbench.mp4read, vcpbench.content\n"
        "import vcpbench.h264ref.decoder, vcpbench.h264ref.inter_cabac\n"
        "import vcpbench.h264ref.inter_recon\n"
        "import vcpbench.h264ref.deblock_host\n")
    assert not mods & (FORBIDDEN | {"vcp_tpu_torch", "torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vcp_tpu_torch_fake", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vcp_tpu.fake", sys)
    assert bench.forbidden_modules() == ["vcp_tpu"]
