"""Fault injection and restart across processes: the crash and resume
cases of tests/test_multihost.py for the port's 1-D sharded ALS, run as 2
gloo processes x 4 host entries through ``python -m
recommendation_models_tpu_torch.probes.multiprocess``.

Each process exits with code 17 after sweep 2, once process 0 has written
the checkpoint; the restart with ``--resume`` finishes the fit. The
finished fit is held against the JAX package's uninterrupted fit on its 8
forced CPU devices at the reference's tolerances, and bit for bit against
the port's uninterrupted one-process fit (history included), or, for the
resume on another mesh shape, against the same restart in one process.
The fits themselves: tests/test_torch_multiprocess.py."""

import os

import pytest
import torch

from recommendation_models_tpu_torch.parallel.mesh import get_mesh
from tests.test_torch_multiprocess import check, port_one, ref_als, run_probe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    """The stepwise allgather fit: the JAX package's and the port's in one
    process."""
    return ref_als(), port_one()


def test_fault_injection_restart_resume(tmp_path, reference):
    """A checkpoint a sweep, process 0 writing; the resumed fit reproduces
    the uninterrupted one."""
    run_probe(tmp_path, "--crash-after-sweep", "2", expect=17)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000001", "step_00000002"]
    assert not (tmp_path / "result.npz").exists()
    run_probe(tmp_path, "--resume")
    check(tmp_path, *reference)


@pytest.mark.parametrize("exchange", ["allgather", "hybrid"])
def test_scanned_fit_crash_resume(tmp_path, reference, exchange):
    """A 2-sweep ``make_fit``, a checkpoint, a hard exit; the resume runs
    the remaining sweeps as one more ``make_fit``."""
    extra = ("--scanned", "--exchange", exchange)
    run_probe(tmp_path, *extra, "--crash-after-sweep", "2", expect=17)
    assert os.path.isdir(tmp_path / "ckpt")
    assert not (tmp_path / "result.npz").exists()
    run_probe(tmp_path, *extra, "--resume")
    check(tmp_path, reference[0] if exchange == "allgather"
          else ref_als(exchange, scanned=True),
          port_one(exchange, scanned=True))


def test_cross_mesh_shape_restore_resumes_fit(tmp_path, reference):
    """A checkpoint of 1 process x 8 entries resumes on 2 processes x 2
    entries (4 shards); bit for bit the same restart in one process on 4
    entries."""
    run_probe(tmp_path, "--crash-after-sweep", "2", n=1, expect=17)
    run_probe(tmp_path, "--resume", devices=4)
    ckpt = str(tmp_path / "one" / "ckpt")
    port_one(crash_after=2, ckpt_dir=ckpt)
    one = port_one(mesh=get_mesh(4, platform="cpu"), resume=True,
                   ckpt_dir=ckpt)
    check(tmp_path, reference[0], one)
