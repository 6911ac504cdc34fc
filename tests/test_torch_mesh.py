"""Port parity: parallel/mesh (process meshes on torch.distributed) after
tests/test_mesh.py, over 4 gloo ranks spawned on the CPU
(tests/torch_ranks.mesh_cases, a 60 s process-group timeout and a
deadline for the whole run) and single-process, without any process
group, here."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import torch_ranks
from spherical_bundle_adjuster_tpu.parallel import mesh as jmesh
from spherical_bundle_adjuster_tpu_torch.parallel import launch, mesh as tmesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return launch.run_ranks(torch_ranks.mesh_cases, WORLD, threads=1,
                            timeout_s=torch_ranks.TIMEOUT.total_seconds(), deadline_s=180)


def test_make_mesh_1d(ranks):
    """make_mesh() spans every rank, make_mesh(2) the first two (the JAX
    package's devices[:n]); the others are outside it and have no axis."""
    for r, out in enumerate(ranks):
        assert out["1d"]["shape"] == {"data": WORLD} and out["1d"]["coords"] == {"data": r}
        assert out["1d"]["rank_sums"] == {"data": 0 + 1 + 2 + 3}
        m2 = out["1d_first2"]
        assert m2["shape"] == {"data": 2} and m2["ranks"] == [0, 1]
        if r < 2:
            assert m2["coords"] == {"data": r} and m2["rank_sums"] == {"data": 1}
        else:
            assert m2["coords"] is None and "not in the mesh" in m2["outside"]


def test_make_mesh_2d_shape_and_layout(ranks):
    """2 x 2 over 4 ranks: contiguous ranks on the inner (landmark) axis,
    as the JAX package lays it over ICI; each axis's all-reduce sums over
    this rank's line only."""
    for r, out in enumerate(ranks):
        m = out["2x2"]
        assert m["shape"] == {"pairs": 2, "data": 2}
        assert m["ranks"] == [[0, 1], [2, 3]]
        assert m["coords"] == {"pairs": r // 2, "data": r % 2}
        row, col = r // 2, r % 2
        assert m["rank_sums"] == {"data": 2 * row + 2 * row + 1, "pairs": col + col + 2}


def test_make_mesh_2d_infers_inner(ranks):
    for out in ranks:
        assert out["2x_inferred"]["shape"] == {"pairs": 2, "data": WORLD // 2}


def test_make_mesh_2d_too_big(ranks):
    """More ranks than the job has: AssertionError, over ranks and
    single-process (the JAX test's make_mesh_2d(len(devices), 2))."""
    for out in ranks:
        assert "needs 8 ranks, have 4" in out["too_big"]
    with pytest.raises(AssertionError):
        tmesh.make_mesh_2d(1, 2)
    with pytest.raises(AssertionError):
        jmesh.make_mesh_2d(8, 2)


def test_shard_leading_and_replicated(ranks):
    """shard_leading keeps this rank's contiguous block of the leading
    axis (ValueError where it does not divide); replicated gives every
    rank the first rank's tensor."""
    x0 = torch.arange(8 * 3).reshape(8, 3)
    for r, out in enumerate(ranks):
        assert torch.equal(out["shard"], x0[2 * r:2 * r + 2] + 100 * r)
        assert torch.equal(out["replicated"], x0)
        assert "does not divide" in out["indivisible"]
        assert out["backend"] == "gloo"


def test_init_distributed_single_process(monkeypatch):
    """No job environment: stays single-process and returns 0, and local
    meshes keep working, with identity collectives (the JAX test's
    fallback path)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed() == 0
    assert not dist.is_initialized()
    m = tmesh.make_mesh(1)
    assert m.shape == {"data": 1} and m.coords == {"data": 0}
    assert tmesh.make_mesh().shape == {"data": 1}
    axis = m.axis("data")
    x = torch.ones(3, 2)
    assert axis.all_reduce(x) is x and axis.broadcast(x) is x and axis.all_gather(x) is x
    assert axis.calls() == 1 and axis.bytes() == 24
    assert axis.traffic == {("all_reduce", 24): 1, ("broadcast", 24): 1, ("all_gather", 24): 1}
    with pytest.raises(KeyError):
        m.axis("pairs")
    with pytest.raises(ValueError):
        tmesh.init_distributed("localhost:1", 2)


def test_init_distributed_reads_the_torchrun_environment():
    """With torchrun's variables set (one rank here, a port the OS gave),
    init_distributed() joins the group they name, with gloo where there
    is no card, and a second call returns the same rank."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(launch.free_port()), PYTHONPATH=str(ROOT))
    code = ("import torch.distributed as d\n"
            "from spherical_bundle_adjuster_tpu_torch.parallel import mesh\n"
            "r = mesh.init_distributed()\n"
            "assert d.is_initialized() and mesh.init_distributed() == r == 0\n"
            "print(d.get_backend(), d.get_world_size(), mesh.make_mesh().shape)\n"
            "d.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gloo", "1", "{'data':", "1}"]
