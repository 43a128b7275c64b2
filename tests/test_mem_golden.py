"""End-to-end `mem` parity: SAM output must be byte-identical to the
reference aligner's golden files (all lines except the @PG command line,
whose argv[0] differs by construction)."""
import io
import os
import sys

import pytest

from bwamem_tpu import cli


def run_mem(args):
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        ret = cli.main_mem(["--engine", "jax"] + args)
    finally:
        sys.stdout = old
    assert ret == 0
    return [l for l in out.getvalue().split("\n") if not l.startswith("@PG")]


def load_golden(path):
    with open(path) as f:
        return [l for l in f.read().split("\n") if not l.startswith("@PG")]


def test_mem_se(data_dir):
    ours = run_mem([os.path.join(data_dir, "genome.fa"),
                    os.path.join(data_dir, "reads_se.fq")])
    assert ours == load_golden(os.path.join(data_dir, "golden_se.sam"))


def test_mem_se_all_marksecondary(data_dir):
    ours = run_mem(["-a", "-M", os.path.join(data_dir, "genome.fa"),
                    os.path.join(data_dir, "reads_se.fq")])
    assert ours == load_golden(os.path.join(data_dir, "golden_se_aM.sam"))


def test_mem_pe(data_dir):
    ours = run_mem([os.path.join(data_dir, "genome.fa"),
                    os.path.join(data_dir, "reads_1.fq"),
                    os.path.join(data_dir, "reads_2.fq")])
    assert ours == load_golden(os.path.join(data_dir, "golden_pe.sam"))


@pytest.mark.parametrize("backend,want", [("cpu", "host"), ("gpu", "jax")])
def test_auto_engine_by_backend(monkeypatch, backend, want):
    """--engine auto: the device engine on an accelerator backend, the
    host oracle engine on the CPU backend."""
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert cli.auto_engine() == want


def test_mem_auto_engine_matches_golden(data_dir):
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        ret = cli.main_mem([os.path.join(data_dir, "genome.fa"),
                            os.path.join(data_dir, "reads_se.fq")])
    finally:
        sys.stdout = old
    assert ret == 0
    assert [l for l in out.getvalue().split("\n")
            if not l.startswith("@PG")] == \
        load_golden(os.path.join(data_dir, "golden_se.sam"))


def test_mem_rejects_unknown_engine(data_dir):
    assert cli.main_mem(["--engine", "fpga",
                         os.path.join(data_dir, "genome.fa"),
                         os.path.join(data_dir, "reads_se.fq")]) == 1
