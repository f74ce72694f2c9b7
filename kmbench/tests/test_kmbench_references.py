"""A configuration names the reference that judges it, and a traffic mix
its file format: the run and the control call the named module, a name
that is not one fails before any work, and runs on FASTQ collections are
judged like runs on FASTA."""

import sys
import types

import pytest

from kmbench import cells, run
from kmbench import reference as default

STUB = "kmbench.reference._stub"


@pytest.fixture
def stub(monkeypatch):
    """A reference module ``kmbench.reference._stub`` that hands every call
    to :mod:`kmbench.reference` and records its name."""
    mod = types.ModuleType(STUB)
    mod.calls = []

    def relay(name):
        def call(*a, **kw):
            mod.calls.append(name)
            return getattr(default, name)(*a, **kw)
        return call
    for name in default.INTERFACE:
        setattr(mod, name, relay(name))
    monkeypatch.setitem(sys.modules, STUB, mod)
    return mod


def test_a_configuration_without_reference_takes_the_default(tiny_cell):
    assert cells.reference(tiny_cell()) is default
    for w in cells.benchmark()["workloads"]:
        assert cells.reference(cells.load_cell(w["name"])) is default


@pytest.mark.parametrize("name", [
    "os", "kmbench.run", "kmbench.referencex", "kmbench.reference.",
    "kmbench.reference..kmers", "kmbench.reference.kmers-2",
    "kmbench.reference.kmers", "kmbench.reference.layout"])
def test_a_reference_outside_the_package_or_the_interface_is_refused(
        tiny_cell, name):
    with pytest.raises(ValueError, match="reference"):
        cells.reference(tiny_cell(reference=name))


def test_a_missing_reference_fails_before_any_work(tiny_cell, monkeypatch):
    def no_bank(*a, **kw):
        raise AssertionError("the collection was written")
    monkeypatch.setattr(run, "make_bank", no_bank)
    with pytest.raises(ModuleNotFoundError):
        run.run_cell(tiny_cell(reference="kmbench.reference.missing"),
                     2**31 + 9, 0.2, False, device="cpu")


def test_an_unknown_format_fails_before_any_work(tiny_cell, monkeypatch):
    def no_bank(*a, **kw):
        raise AssertionError("the collection was written")
    monkeypatch.setattr(run, "make_bank", no_bank)
    with pytest.raises(ValueError, match="format"):
        run.run_cell(tiny_cell(fmt="bam"), 2**31 + 9, 0.2, False,
                     device="cpu")


def test_the_named_reference_judges_the_run(tiny_cell, stub):
    # on plain FASTQ, which no other run test writes
    r = run.run_cell(tiny_cell(fmt="fastq", reference=STUB), 2**31 + 21,
                     0.2, False, device="cpu")
    assert r["correct"], r["checks"]
    assert stub.calls[0] == "options"
    assert stub.calls[1:] == ["setup", "read_file", "judge"]


def test_the_named_reference_is_the_control(tiny_cell, stub, tmp_path):
    import torch

    from kmbench.control import control_checks
    from kmbench.gen import make_bank

    cell = tiny_cell(reference=STUB)
    manifest = make_bank(cell["traffic_spec"], 11, str(tmp_path / "bank"))
    checks = control_checks(cell, manifest, torch.device("cpu"))
    assert checks["rows_bad"] > 0
    assert stub.calls == ["setup", "control_options", "expected_outputs",
                          "serialize", "judge"]


@pytest.mark.parametrize("fmt", ["fasta", "fastq.gz"])
def test_a_run_on_each_format_is_correct(tiny_cell, fmt):
    r = run.run_cell(tiny_cell(fmt=fmt), 2**31 + 33, 0.2, False,
                     device="cpu")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
