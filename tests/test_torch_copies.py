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


def _block(text: str, start: str) -> str:
    """The lines of ``text`` from the one starting with ``start`` to the
    next blank line."""
    lines = text.splitlines()
    i = next(n for n, line in enumerate(lines) if line.startswith(start))
    j = next(n for n in range(i, len(lines)) if not lines[n].strip())
    return "\n".join(lines[i:j])


@pytest.mark.parametrize("start", ["BATCH = ", "_RULES: Sequence", "_ATTN_CACHE = "])
def test_sharding_rules_are_the_references_verbatim(start):
    """``repro_torch.distributed.sharding`` is a port, not a copy (it
    imports torch), but its rule tables are the reference's, line for
    line: read as text, neither module imported."""
    ref = (REF / "distributed" / "sharding.py").read_text()
    port = (PORT / "distributed" / "sharding.py").read_text()
    assert _block(port, start) == _block(ref, start)


def test_distributed_package_is_a_port_that_names_neither_jax_nor_the_reference():
    """The three modules of the reference's distributed package have ports
    of the same names, and none of them imports jax or repro."""
    ref = {p.name for p in (REF / "distributed").glob("*.py")}
    port = {p.name for p in (PORT / "distributed").glob("*.py")}
    assert ref == port == {"__init__.py", "sharding.py", "compression.py", "pipeline.py"}
    for name in port:
        text = (PORT / "distributed" / name).read_text()
        assert text != (REF / "distributed" / name).read_text()
        imports = [ln.strip() for ln in text.splitlines() if ln.strip().startswith(("import ", "from "))]
        assert not any("jax" in ln or ln.startswith(("import repro", "from repro")) for ln in imports), name


def test_launch_package_ports_every_reference_module_but_hlocost():
    """Every module of the reference's launch package has a port of the
    same name, but for ``hlocost.py`` (the port emits no HLO; its
    counterpart is ``cost.py``, the per-op counter), and the counterparts
    of ``benchmarks/roofline.py`` and ``benchmarks/kernels_micro.py`` live
    beside them (``launch/roofline.py``, ``launch/micro.py``).  None of
    them imports jax, repro or benchmarks."""
    ref = {p.name for p in (REF / "launch").glob("*.py")}
    port = {p.name for p in (PORT / "launch").glob("*.py")}
    assert ref - port == {"hlocost.py"} and {"cost.py", "micro.py"} <= port
    for path in [PORT / "launch" / name for name in port]:
        imports = [ln.strip() for ln in path.read_text().splitlines() if ln.strip().startswith(("import ", "from "))]
        bad = [ln for ln in imports if "jax" in ln or ln.startswith(("import repro ", "import repro.", "from repro ",
                                                                     "from repro.", "import benchmarks",
                                                                     "from benchmarks"))]
        assert not bad, (path.name, bad)
