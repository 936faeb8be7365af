"""The solver launcher's distributed flags on the CPU.

``--shards``, ``--devices``, ``--partition``, ``--weights`` and ``--sub``
through ``repro_torch.launch.solve.main``, on a mesh of host shards: the
plan printed is the one the flags ask for (the nnz cut equals
``core.perfmodel.decompose`` at the given weights) and the solve
converges. The default devices put shard 0 on the card, so without a GPU
they raise rather than fall back to the host. ``launch.sum_order`` runs on
a small grid.
"""
import re

import pytest
import torch

from repro_torch.core.perfmodel import decompose
from repro_torch.launch import solve as cli
from repro_torch.launch import sum_order
from repro_torch.sparse import poisson27

CPU4 = ["--devices", "cpu,cpu,cpu,cpu"]
BASE = ["--device", "cpu", "--matrix", "poisson27:12", "--atol", "0", "--rtol", "1e-5"]


def _field(out, name):
    return re.search(rf"{name}=(\([^)]*\)|\S+?)(,|$)", out, re.M).group(1)


@pytest.mark.parametrize("argv,want", [
    (["--method", "h3", "--shards", "4", *CPU4, "--partition", "nnz", "--weights", "2,1,1,1"],
     {"reducer": "packed", "spmv_strategy": "halo", "partition": "nnz"}),
    (["--method", "h4", "--shards", "4", *CPU4, "--sub", "2", "--rhs", "2"],
     {"reducer": "h4", "sub": "2", "mesh_axes": "('pod', 'rows')"}),
    (["--method", "pl2", "--shards", "2", "--devices", "cpu,cpu"],
     {"pipeline_depth": "2", "shard_cores": "('coordinate', 'coordinate')"}),
])
def test_cli_distributed_flags(capsys, argv, want):
    cli.main(BASE + argv)
    out = capsys.readouterr().out
    for key, value in want.items():
        assert _field(out, key) == value, (key, out)
    assert _field(out, "mesh_devices") == str(("cpu",) * int(argv[argv.index("--shards") + 1]))
    assert "converged=True" in out
    if "--weights" in argv:
        A = poisson27(12, device="cpu")
        assert _field(out, "shard_bounds") == str(tuple(decompose(A, 4, [2, 1, 1, 1]).tolist()))
    if "--rhs" in argv:
        assert "traces=2" in out


def test_cli_distributed_refusals():
    with pytest.raises(SystemExit):  # a single-device method takes no shards
        cli.main(BASE + ["--method", "pipecg", "--shards", "2"])
    if not torch.cuda.is_available():  # the default mesh: the card, then the host
        with pytest.raises(RuntimeError):
            cli.main(BASE + ["--method", "h3", "--shards", "2"])


def test_sum_order_launcher(capsys):
    sum_order.main(["--device", "cpu", "--grid", "8", "--rtols", "1e-4"])
    out = capsys.readouterr().out
    f32 = [ln for ln in out.splitlines() if ln.startswith("rtol=0.0001 float32 ")]
    f64 = [ln for ln in out.splitlines() if ln.startswith("rtol=0.0001 float64 ")]
    # the plan, 8 orders of the dots, the SPMV rounded once, 2 meshes, the spread
    assert len(f32) == 13 and len(f64) == 4
    assert all("converged=True" in ln for ln in f32[:-1] + f64[:-1])
    # the plain loop summed as the core sums is the plan's own solve
    assert "as the core sums: iterations=" in f32[1]
    assert f32[1].endswith("max|x-x_plan|=0.000e+00")
    # float64: both h3 meshes take the single solve's iterations
    assert f64[-1].endswith("all {0}..{0}".format(re.search(r"iterations=(\d+)", f64[0])[1]))
