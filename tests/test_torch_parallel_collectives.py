"""The port's meshes and autograd collectives (`early_exit_tpu_torch.parallel`)
in one gloo world of 4 CPU processes, spawned once for the module.

Each rank runs `_rank_checks` (this file run as a script) and writes what
it saw; the tests read it:
- `make_mesh`: the data x model groups of dp=2 x tp=2 (ranks fill it
  row-major, model innermost), the replica axis of dcn=2, a mesh over a
  subset of the ranks (None outside it), and dcn x dp x tp != the ranks
  raising by name; `make_hybrid_mesh` on two nodes and on one;
- the four collectives' forward and backward, with upstream gradients
  that differ from rank to rank: copy_to_model (identity, all-reduce over
  the model group), reduce_from_model (all-reduce, identity),
  gather_from_model along uneven shards (5 columns over 2 ranks: 3 + 2;
  all-gather, this rank's slice) and all_reduce_batch (all-reduce over the
  batch group both ways);
- the reason for them: `torch.distributed.nn.functional.all_reduce` sums
  the gradient over the group, so a model group that computed one
  replicated loss would see it tp times.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4


def _rank_checks(rank: int, port: int, out: str) -> None:
    from early_exit_tpu_torch import parallel
    from early_exit_tpu_torch.parallel import collectives as C

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    res = {}
    mesh = parallel.make_mesh(dp=2, tp=2)
    res["mesh"] = dict(shape=mesh.shape, model_rank=mesh.model_rank,
                       batch_rank=mesh.batch_rank, axes=parallel.batch_axes(mesh),
                       model_peers=dist.get_process_group_ranks(mesh.model_group),
                       batch_peers=dist.get_process_group_ranks(mesh.batch_group))
    dcn = parallel.make_mesh(dcn=2, dp=1, tp=2)
    res["dcn"] = dict(shape=dcn.shape, axes=parallel.batch_axes(dcn), n_batch=dcn.n_batch,
                      batch_rank=dcn.batch_rank)
    sub = parallel.make_mesh([0, 1], dp=2)
    res["sub"] = None if sub is None else dict(shape=sub.shape, batch_rank=sub.batch_rank)
    os.environ["LOCAL_WORLD_SIZE"] = "2"          # two nodes of two ranks
    res["hybrid"] = parallel.make_hybrid_mesh(tp=2).shape
    os.environ["LOCAL_WORLD_SIZE"] = str(WORLD)      # one node
    res["hybrid_one_node"] = parallel.make_hybrid_mesh(tp=2).shape
    try:
        parallel.make_mesh(dp=3, tp=2)
        res["bad"] = "no error"
    except ValueError as e:
        res["bad"] = str(e)

    w = float(rank + 1)                  # a rank-dependent upstream gradient
    x = torch.full((2,), float(rank), requires_grad=True)
    y = C.copy_to_model(x, mesh)
    (y * w).sum().backward()
    res["copy"] = dict(fwd=y.tolist(), grad=x.grad.tolist())

    x = torch.full((2,), float(rank), requires_grad=True)
    y = C.reduce_from_model(x, mesh)
    (y * w).sum().backward()
    res["reduce"] = dict(fwd=y.tolist(), grad=x.grad.tolist())

    width = 3 if mesh.model_rank == 0 else 2         # tensor_split of 5 over 2
    off = 0 if mesh.model_rank == 0 else 3
    x = (torch.arange(width, dtype=torch.float32) + off + 10 * mesh.batch_rank
         ).requires_grad_(True)
    y = C.gather_from_model(x[None], mesh, 5)[0]
    (y * torch.arange(5.0) * w).sum().backward()
    res["gather"] = dict(fwd=y.tolist(), grad=x.grad.tolist())

    x = torch.full((2,), float(rank), requires_grad=True)
    y = C.all_reduce_batch(x, mesh)
    (y * w).sum().backward()
    res["batch"] = dict(fwd=y.tolist(), grad=x.grad.tolist())

    import torch.distributed.nn.functional as dnn
    x = torch.full((2,), 1.0, requires_grad=True)
    dnn.all_reduce(x * 2, group=mesh.model_group).sum().backward()
    res["stock"] = x.grad.tolist()

    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from early_exit_tpu_torch.multiprocess_smoke import free_port
    out = str(tmp_path_factory.mktemp("collectives"))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(port), out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    res = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def test_meshes(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert m["shape"] == {"data": 2, "model": 2}
        assert (m["batch_rank"], m["model_rank"]) == divmod(r, 2)
        assert m["model_peers"] == [r - r % 2, r - r % 2 + 1]
        assert m["batch_peers"] == [r % 2, r % 2 + 2]
        assert m["axes"] == ["data"]
        d = res["dcn"]
        assert d["shape"] == {"replica": 2, "data": 1, "model": 2}
        assert d["axes"] == ["replica", "data"] and d["n_batch"] == 2
        assert d["batch_rank"] == r // 2
        assert res["sub"] == (None if r >= 2 else {"shape": {"data": 2, "model": 1},
                                                   "batch_rank": r})
        assert "dcn(1) * dp(3) * tp(2) != n_ranks(4)" in res["bad"]


def test_hybrid_mesh(ranks):
    """One replica per node (WORLD_SIZE // LOCAL_WORLD_SIZE), make_mesh on
    one node, as the JAX package's make_hybrid_mesh."""
    for res in ranks:
        assert res["hybrid"] == {"replica": 2, "data": 1, "model": 2}
        assert res["hybrid_one_node"] == {"data": 2, "model": 2}


def test_copy_and_reduce(ranks):
    for r, res in enumerate(ranks):
        peers = [r - r % 2, r - r % 2 + 1]
        # copy: identity forward; backward sums the peers' upstream gradients
        assert res["copy"]["fwd"] == [float(r)] * 2
        assert res["copy"]["grad"] == [float(sum(p + 1 for p in peers))] * 2
        # reduce: sum forward; backward passes this rank's gradient alone
        assert res["reduce"]["fwd"] == [float(sum(peers))] * 2
        assert res["reduce"]["grad"] == [float(r + 1)] * 2


def test_gather_uneven_shards(ranks):
    for r, res in enumerate(ranks):
        b, m = divmod(r, 2)
        assert res["gather"]["fwd"] == [float(c + 10 * b) for c in range(5)]
        cols = range(3) if m == 0 else range(3, 5)
        assert res["gather"]["grad"] == [float(c * (r + 1)) for c in cols]


def test_all_reduce_batch_sums_both_ways(ranks):
    for r, res in enumerate(ranks):
        peers = [r % 2, r % 2 + 2]
        assert res["batch"]["fwd"] == [float(sum(peers))] * 2
        assert res["batch"]["grad"] == [float(sum(p + 1 for p in peers))] * 2


def test_stock_all_reduce_sums_a_replicated_gradient(ranks):
    """d/dx of all_reduce(2x) summed over the model group: each rank's own
    share is 2, the stock collective gives 2 x tp."""
    for res in ranks:
        assert res["stock"] == [4.0, 4.0]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_checks(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
