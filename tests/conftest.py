"""Test configuration: hold JAX to the CPU with 8 virtual devices, so
the multi-device sharding paths run without a GPU (SURVEY.md §4 item 4).
The platform is also set through jax.config after import, before the
first device use, in case a site hook set it differently."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


SYNTH_NAME = "synth_phage"
SYNTH_LEN = 5386        # phiX174's length; the sequence is seeded random


@pytest.fixture(scope="session")
def synth_fasta(tmp_path_factory):
    """A seeded single-scaffold genome written as FASTA (60 bases a
    line): (path, sequence bytes, scaffold name). Stands in for a small
    phage reference."""
    seq = np.random.default_rng(174).choice(
        np.frombuffer(b"ACGT", np.uint8), SYNTH_LEN).tobytes()
    path = tmp_path_factory.mktemp("synth") / "synth_phage.fa"
    lines = [seq[i:i + 60] for i in range(0, len(seq), 60)]
    path.write_bytes(b">" + SYNTH_NAME.encode() + b" seeded\n"
                     + b"\n".join(lines) + b"\n")
    return str(path), seq, SYNTH_NAME


# ---------------------------------------------------------------------
# slow-test gating (VERDICT r3 #10): the multi-minute e2e/multiprocess/
# device-parity tests carry @pytest.mark.slow and are SKIPPED by
# default so the iteration loop stays fast. Run everything with
#
#     python -m pytest tests/ --runslow            (full battery)
#     python -m pytest tests/ -n auto --runslow    (parallel, fastest)
#
# CI/driver runs of the default path stay green either way.
# ---------------------------------------------------------------------

def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute e2e/parity test (needs --runslow)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
