"""The port stands alone: every module of hichap_master_tpu_torch imports
with jax, h5py and pandas blocked (the GPU machine has none of them) and
with the JAX package blocked, and chip_smoke.py refuses to run without a
CUDA device or without the repo."""

import fnmatch
import os
import shutil
import subprocess
import sys
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import sys
for name in ("jax", "jaxlib", "h5py", "pandas", "hichap_master_tpu"):
    sys.modules[name] = None          # any import of them now raises
import importlib, pkgutil
import hichap_master_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for mod in ("matrix", "filtering", "bam_process", "pairs", "columns",
            "enzyme", "genome_rebuild", "chunking", "rescue", "mapping"):
    assert f"hichap_master_tpu_torch.pipeline.{mod}" in names, names
for mod in ("exact_index", "exact_hits"):
    assert f"hichap_master_tpu_torch.kernels.{mod}" in names, names
for io in ("bedio", "cooler", "hdf5", "sam", "bam", "fasta"):
    assert f"hichap_master_tpu_torch.io.{io}" in names, names
for mod in ("cli", "utils", "utils.logging", "utils.profiling"):
    assert f"hichap_master_tpu_torch.{mod}" in names, names
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in ("jax", "jaxlib")]
assert not loaded, loaded
print(len(names))
"""


def _env(**extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(extra)
    return env


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=_env())
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 50  # every module was imported


_HOST_BUILD = """
import ctypes, shutil, sys
from pathlib import Path
assert shutil.which("nvcc") is None
from hichap_master_tpu_torch.kernels import _build
from hichap_master_tpu_torch.io import bedio
path = Path(sys.argv[1]) / "libhost.so"
_build.build_host(path)
_build.host_library_path = lambda: path
print(bedio._parse_allelic(b"chr1\\t5\\t1\\t9\\tR2\\n", ["1"], True))
"""


def test_host_scanner_builds_without_nvcc(tmp_path):
    """The bed scanner is host C++: it builds with the host compiler where
    no nvcc is on the path."""
    path = os.pathsep.join(p for p in os.environ["PATH"].split(os.pathsep)
                           if not os.path.exists(os.path.join(p, "nvcc")))
    r = subprocess.run([sys.executable, "-c", _HOST_BUILD, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=_env(PATH=path))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "libhost.so").exists()
    assert "array([2], dtype=int8)" in r.stdout


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=_env(CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_cuda():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_package_data_ships_every_source():
    """Every kernel and host source the port builds at run time is listed
    in the package data, so that an installed port can build it."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    pats = data["hichap_master_tpu_torch"]
    csrc = os.path.join(REPO, "hichap_master_tpu_torch", "csrc")
    names = os.listdir(csrc)
    assert "bedparse.cpp" in names
    for name in names:
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in pats), name
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["hichap-torch"] == "hichap_master_tpu_torch.cli:main"
