"""The port keeps byte-identical copies of the reference's jax-free modules
(configs, core, cache, runtime, obs, workload, serving/engine,
training/data).  Each pair
is read as bytes and compared; neither is imported, so drift in either
package shows here."""

from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"


def _copied():
    files = []
    for pkg in ("configs", "core", "runtime", "workload"):
        files += sorted(p.relative_to(REF).as_posix() for p in (REF / pkg).glob("*.py"))
    files += ["cache/__init__.py", "cache/radix.py", "cache/hierarchy.py",
              "obs/__init__.py", "obs/metrics.py", "obs/tracing.py", "serving/engine.py",
              "training/data.py"]
    return files


COPIED = _copied()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_byte_identical(rel):
    ref, port = REF / rel, PORT / rel
    assert port.exists(), f"repro_torch/{rel} is missing"
    assert port.read_bytes() == ref.read_bytes(), f"repro_torch/{rel} drifted from repro/{rel}"


def test_copy_list_covers_the_packages():
    """Every module of the copied packages is in the list, and the two
    modules left out of obs (they pull in cluster/) are absent."""
    for pkg in ("configs", "core", "runtime", "workload"):
        port_files = {p.relative_to(PORT).as_posix() for p in (PORT / pkg).glob("*.py")}
        assert port_files == {f for f in COPIED if f.startswith(pkg + "/")}
    assert not (PORT / "obs" / "catalog.py").exists()
    assert not (PORT / "obs" / "httpd.py").exists()
