"""Rank processes for ``tests/test_torch_mesh_round.py``: each job runs in
a spawned process per rank of a ``gloo`` world, so no process group is
ever started in a pytest worker. No JAX here: the test file holds the
results against the JAX package.

``start_world`` spawns the ranks; ``join_world`` waits for them and
returns each rank's result (what the job returned, through a file).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os

import torch
import torch.distributed as dist

#: the reduced granite of the ep cases: 8 experts, top 2, so that the
#: local capacity (2 ceil(T k / E)) sits under the tokens one expert can
#: get and a skewed router drops slots
EP_REDUCED = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  d_ff=256, vocab=256, n_experts=8, top_k=2)


def start_world(world: int, jobs, tmp: str):
    """Spawn ``world`` ranks, each running ``jobs`` ([(job name,
    payload), ...]) in order; returns the processes."""
    ctx = multiprocessing.get_context("spawn")
    init = os.path.join(tmp, f"world{world}.store")
    procs = [ctx.Process(target=_rank_main,
                         args=(jobs, rank, world, init, tmp))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs, tmp: str, timeout: float = 240.0):
    """Wait for the ranks; each must exit 0. Returns each rank's results
    by job name."""
    for p in procs:
        p.join(timeout)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert codes == [0] * len(procs), f"rank exit codes {codes}"
    return [torch.load(_out(tmp, len(procs), r), weights_only=False)
            for r in range(len(procs))]


def _out(tmp, world, rank):
    return os.path.join(tmp, f"world{world}-{rank}.pt")


def _rank_main(jobs, rank, world, init, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        result = {name: JOBS[name](rank, world, payload)
                  for name, payload in jobs}
    finally:
        dist.destroy_process_group()
    torch.save(result, _out(tmp, world, rank))


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def ep_cfg():
    from repro_torch.configs import ReducedSpec, get_config, reduce_config
    return reduce_config(get_config("granite-moe-1b-a400m"),
                         ReducedSpec(**EP_REDUCED))


def ep_job(rank, world, payload):
    """``moe_block_ep`` on the (data, model) mesh ``payload["shape"]``:
    this rank's tokens are its data shard of x; the loss is
    sum(y * g) + aux. Returns the rank's coordinate, y, aux, the
    gradients of its x and of the whole expert weights, and how many of
    its slots routed to its experts dropped."""
    from repro_torch.models import moe as Moe

    cfg = ep_cfg()
    mesh = _mesh(payload["shape"])
    di, mi = mesh.get_coordinate()
    dp = payload["shape"][0]
    t = payload["x"].shape[0] // dp
    rows = slice(di * t, (di + 1) * t)
    x = torch.from_numpy(payload["x"][rows]).requires_grad_(True)
    g = torch.from_numpy(payload["g"][rows])
    params = {k: torch.from_numpy(v).requires_grad_(k != "router")
              for k, v in payload["params"].items()}
    y, aux = Moe.moe_block_ep(params, cfg, x, mesh=mesh)
    ((y * g).sum() + aux).backward()

    # the slots routed to this rank's experts past the local capacity
    m = cfg.moe
    e_local = m.n_experts // payload["shape"][1]
    _, idx, _ = Moe.router_topk(params, cfg, x.detach())
    counts = torch.stack([(idx == e).sum() for e in range(m.n_experts)])
    cap_l = max(8, -(-t * m.top_k // m.n_experts) * 2)
    drops = int((counts.clamp(min=cap_l) - cap_l)[
        mi * e_local:(mi + 1) * e_local].sum())
    return {"coord": (di, mi), "y": y.detach().numpy(),
            "aux": float(aux), "dx": x.grad.numpy(),
            **{f"d{k}": params[k].grad.numpy() for k in ("wg", "wu", "wd")},
            "drops": drops}


def host_job(rank, world, payload):
    """On the 1x1 mesh: the round engine's ``mesh="host"`` runs against
    its ``mesh=None`` runs from the JAX package's params and LoRA; the
    model's ``gather_sharded`` path and its placed params against the
    plain ``gather`` path."""
    from repro_torch import interop
    from repro_torch.experiments import ExperimentSpec, run_experiment
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    out = {"runs": {}}
    for name, run in payload["runs"].items():
        spec = ExperimentSpec.from_dict(run["spec"])
        for mesh in (None, "host"):
            res = run_experiment(
                spec.replace(mesh=mesh), device="cpu",
                params=interop.from_numpy_tree(run["params"]),
                lora=interop.from_numpy_tree(run["lora"]))
            out["runs"][(name, mesh)] = (
                [dataclasses.asdict(log) for log in res.logs],
                interop.to_numpy_tree(res.final_lora))

    mesh = make_host_mesh("cpu")
    cfg = ep_cfg()
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, torch.float32)
    lora = T.init_lora(cfg, gen, rank=4)
    lora = interop.tree_map(lambda t: t + 0.01, lora)   # b nonzero
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    placed = shd.place(params, shd.params_shardings(mesh, params))
    grads = {}
    for tag, p, path in (("gather", params, "gather"),
                         ("gather_sharded", params, "gather_sharded"),
                         ("placed", placed, "gather"),
                         ("placed ep", placed, "ep"),
                         ("ep", params, "ep")):
        total, _, gr = T.loss_and_lora_grads(cfg, p, lora, batch,
                                             moe_path=path, mesh=mesh)
        grads[tag] = (float(total), interop.to_numpy_tree(gr))
    logits = {tag: T.prefill(cfg, p, lora, batch).numpy()
              for tag, p in (("plain", params), ("placed", placed))}
    out.update(grads=grads, prefill=logits,
               placed_types=sorted({type(t).__name__ for t in
                                    interop.tree_leaves(placed)}))
    return out


def round_job(rank, world, payload):
    """The round engine on a (world, 1) mesh, the sampled clients split
    over ``data``, and (rank 0) the same runner with ``mesh=None``."""
    from repro_torch import interop
    from repro_torch.data.synthetic import make_federated_data
    from repro_torch.experiments import ExperimentSpec
    from repro_torch.federated import FederatedRunner

    mesh = _mesh((world, 1))
    out = {}
    for name, d in payload.items():
        spec = ExperimentSpec.from_dict(d)
        cfg = spec.build_cfg()
        data = make_federated_data(cfg.vocab, n_clients=spec.n_clients,
                                   alpha=spec.alpha, noise=spec.noise,
                                   seed=spec.seed)
        for m in ((None, mesh) if rank == 0 else (mesh,)):
            runner = FederatedRunner(cfg, spec.fed_config(), data,
                                     mesh=m, device="cpu")
            logs = runner.run()
            out[(name, m is not None)] = (
                [dataclasses.asdict(log) for log in logs],
                interop.to_numpy_tree(runner.lora))
    return out


JOBS = {"ep": ep_job, "host": host_job, "round": round_job}
