"""``repro_torch.launch.simulate workload`` prints the reference CLI's line
for a dry-run roofline record (one JAX compile: see test_torch_engine.py
for why this file holds one test)."""
import json
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro.launch import simulate as jsim  # noqa: E402
from repro_torch.launch import simulate as tsim  # noqa: E402


def test_simulate_workload_prints_the_reference_line(tmp_path, monkeypatch,
                                                     capsys):
    rec = {"status": "ok", "arch": "dense", "shape": "train_4k",
           "mesh": "2x4", "roofline": {
               "t_compute_s": 0.031, "t_memory_s": 0.012,
               "coll_by_kind": {"all-reduce": 1.5e9}}}
    (tmp_path / "dense.json").write_text(json.dumps(rec))
    (tmp_path / "failed.json").write_text(json.dumps({"status": "oom"}))
    monkeypatch.setattr(sys, "argv", ["simulate", "workload", "--results",
                                      str(tmp_path)])
    jsim.main()
    want = capsys.readouterr().out.splitlines()
    got = tsim.main(["workload", "--results", str(tmp_path), "--device",
                     "cpu"])
    assert got == want and len(got) == 1
    assert got[0].startswith("[workload] dense x train_4k x 2x4: sim=")
