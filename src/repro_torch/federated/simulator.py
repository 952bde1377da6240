"""Federated fine-tuning simulator — the method-agnostic round engine
(the JAX package's ``repro.federated.simulator``), eager.

Reproduces the paper's experimental protocol (App. B): N=20 devices,
10% sampled per round, K=10 local steps, LoRA rank 32 on W_q/W_v,
AdamW + staged cosine LR. Where the JAX package ``vmap``s the sampled
clients inside one jitted round program, this engine runs them one
after another through ``client.make_local_train`` (the fused
``lora_matmul`` kernel is single-adapter, and the loop keeps peak memory
at one client's), stacks their adapters on a leading client axis, and
hands the stack to the strategy's aggregation. There is no jit cache
and no buffer donation.

Mesh execution: pass ``mesh=`` (a ``DeviceMesh``, ``launch.mesh``) and
every rank runs the engine. The round's frozen params are placed by the
FSDP×TP ``params_shardings`` rules (DTensors, gathered layer by layer in
the model), each rank trains its shard of the sampled clients (the
client axis over ``pod``+``data``, ``batch_shardings``) from the global
LoRA's gathered view, the client LoRA stacks are all-gathered over those
axes so every rank aggregates the whole stack in client order, and the
aggregated tree is placed by ``params_shardings``; the strategy's hooks
and eval see its gathered view. The clients and the aggregation run the
same arithmetic as with ``mesh=None``, so the logs and adapters are the
same bits. The JAX package donates the round's LoRA buffers on mesh
runs; torch has no donation, so nothing is copied for it either.

Everything method-specific — submodel construction, schedules, LR
ramps, aggregation, server-side adapter transforms — lives behind the
``Strategy`` interface (``repro_torch.federated.methods``); this engine
only samples clients, runs local training, and keeps the ``RoundLog``
books. ``FedConfig.method`` selects a strategy from the registry.

Heterogeneous clients: ``FedConfig.population`` names a device fleet
(``repro_torch.federated.heterogeneity``); each round the engine
realizes a host-side :class:`~repro_torch.federated.heterogeneity.
RoundPlan` — per-client local step counts (ragged work as a step mask),
straggler drops under ``FedConfig.straggler_policy``, the aggregation-
weight vector for ``FedConfig.weighting``, and the round's VIRTUAL
duration, accumulated into ``RoundLog.sim_time_s``. The ``uniform``
fleet with ``uniform`` weighting runs the unmasked, unweighted round.

Eval runs every ``FedConfig.eval_every`` rounds (skipped rounds carry
the last evaluated values forward, and the final round always
evaluates). The JAX package fetches a round's eval scalars one round
late to overlap jit dispatch; this engine reads them at once, which
gives the same logs.

Cost accounting (per paper §4.4), as in the JAX package:
* communication — exact bytes of transmitted LoRA tensors, up + down,
  per sampled client (dropped stragglers upload nothing);
* computation — FLOPs proxy 6·N_sub·D per round (N_sub = active submodel
  params, D = tokens actually processed under ragged local work);
* time — the virtual wall-clock above (``sim_time_s``, cumulative);
* memory — bytes of (submodel params + LoRA + Adam state + activation
  estimate) per device, scaled by the stage submodel's depth and width.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.data.synthetic import (
    FederatedData,
    client_round_batches,
    keyed_rng,
)
from repro_torch.federated.aggregation import _tree_bytes
from repro_torch.federated.client import make_local_train
from repro_torch.federated.heterogeneity import (
    POLICIES,
    WEIGHTINGS,
    make_population,
    plan_round,
)
from repro_torch.federated.methods import LocalSpec, make_strategy
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as T


@dataclasses.dataclass
class FedConfig:
    n_clients: int = 20
    sample_frac: float = 0.1
    k_local: int = 10
    local_batch: int = 16
    seq: int = 64
    rounds: int = 30
    lora_rank: int = 32
    lr: float = 1e-4
    method: str = "fedit"   # any name in methods.available_methods()
    eval_every: int = 1     # eval cadence (last round always evals)
    # system-heterogeneity knobs (repro_torch.federated.heterogeneity)
    population: str = "uniform"          # device fleet name
    straggler_policy: str = "accept-partial"
    weighting: str = "uniform"           # uniform | examples | fednova
    deadline_factor: float = 2.0         # x reference full-work time
    # DEVFT knobs
    n_stages: int = 4
    growth: float = 2.0
    initial_capacity: Optional[int] = None
    beta: float = 0.1
    grouping: str = "dglg"
    fusion: str = "dblf"
    # baseline knobs
    lr_stage_factor: float = 10.0    # paper App. B: x10 per stage
    flora_ranks: Optional[List[int]] = None
    aggregation: Optional[str] = None  # override (compatibility runs)
    seed: int = 0


@dataclasses.dataclass
class RoundLog:
    round: int
    stage: int
    capacity: int
    eval_loss: float
    eval_acc: float
    comm_bytes_up: int
    comm_bytes_down: int
    flops: float
    memory_bytes: int
    sim_time_s: float = 0.0   # cumulative virtual wall-clock (§3)
    n_dropped: int = 0        # stragglers zero-weighted this round


def make_round_program(strategy, run_state, sub_cfg, n_sample, mesh=None):
    """The round program: K-step local training for each sampled client
    (in turn), then the strategy's server aggregation. Returns
    ``(round_fn, aux)``; ``round_fn(params, lora, batches, lr,
    masks=None, weights=None) -> new_lora``, and ``aux["up"]`` holds the
    strategy's per-client uplink-byte count after a call.

    Heterogeneous rounds pass per-client step masks ``(C, K)`` for
    ragged local work and the per-client aggregation-weight vector
    ``(C,)``; the uniform round passes neither.

    On a ``mesh``, ``params`` and ``lora`` may be placed (DTensors) and
    ``batches`` and ``masks`` are this rank's shard of the client axis
    (``client_spec``); the clients train from the LoRA's gathered view,
    their stack is gathered whole before the aggregation, and the
    aggregated tree comes back placed by ``params_shardings``.
    """
    local = make_local_train(sub_cfg)
    aux: Dict = {}

    def round_fn(params, lora, batches, lr, masks=None, weights=None):
        view = lora if mesh is None else shd.gathered(lora)
        loras = []
        for c in range(len(batches["labels"])):
            new, _ = local(params, view, {k: v[c] for k, v in
                                          batches.items()}, lr,
                           None if masks is None else masks[c])
            loras.append(new)
        stacked = tree_map(lambda *xs: torch.stack(xs), *loras)
        if mesh is not None:
            spec = client_spec(mesh, n_sample)
            stacked = tree_map(lambda t: shd.gather_part(mesh, spec, t),
                               stacked)
        new_lora, aux["up"] = strategy.aggregate(
            run_state, LocalSpec(sub_cfg, params, view), stacked, n_sample,
            weights=weights)
        if mesh is not None:
            new_lora = shd.place(new_lora,
                                 shd.params_shardings(mesh, new_lora))
        return new_lora

    return round_fn, aux


def client_spec(mesh, n_sample: int) -> tuple:
    """The spec of a leading sampled-client axis of ``n_sample`` clients
    (``batch_shardings``: over as much of pod+data as divides it)."""
    return shd.batch_shardings(
        mesh, torch.empty((n_sample,), device="meta")).spec


def count_params(tree) -> int:
    return int(sum(t.numel() for t in tree_leaves(tree)))


def _step_flops(params, batch, seq) -> float:
    """FLOPs of ONE local step on this (sub)model: 6·N_sub·(B·S)."""
    n = count_params(params["blocks"]) + count_params(params.get("embed"))
    return 6.0 * n * batch * seq


def _round_flops(params, total_steps, batch, seq) -> float:
    """Round FLOPs over the steps clients actually executed."""
    return _step_flops(params, batch, seq) * total_steps


def _memory_bytes(params, lora, batch, seq, cfg) -> int:
    """Per-device bytes: submodel params + LoRA + Adam moments + a rough
    activation estimate scaled by the *submodel's* depth and width (a
    4-layer stage-1 submodel must not report 32-layer activations)."""
    p = _tree_bytes(params)
    lo = _tree_bytes(lora)
    n_layers = sum(n for _, n in cfg.layer_stacks())
    act = batch * seq * cfg.d_model * 4 * n_layers
    return p + 3 * lo + act


class FederatedRunner:
    """Runs one method end-to-end on synthetic federated data.

    ``params`` and ``lora`` default to a fresh random init from
    ``fed.seed`` (a ``torch.Generator`` on ``device``, params in
    ``dtype``, LoRA in f32); passing them (e.g. the JAX package's,
    through ``repro_torch.interop``) runs from the given trees, on their
    device. ``mesh`` (a ``DeviceMesh`` of that device's kind) places each
    round on it (see the module docstring); every rank of its group runs
    the same runner with the same arguments.
    """

    def __init__(self, cfg, fed: FedConfig, data: FederatedData, *,
                 dtype=torch.float32, params=None, lora=None, mesh=None,
                 device="cuda"):
        self.cfg = cfg
        self.fed = fed
        self.data = data
        self.strategy = make_strategy(fed.method, cfg, fed)
        if fed.straggler_policy not in POLICIES:
            raise ValueError(f"unknown straggler_policy "
                             f"{fed.straggler_policy!r}; available: "
                             f"{', '.join(POLICIES)}")
        if fed.weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {fed.weighting!r}; "
                             f"available: {', '.join(WEIGHTINGS)}")
        if fed.deadline_factor <= 0:
            # a non-positive deadline would run the whole fleet into a
            # negative virtual clock with every client dropped
            raise ValueError(f"deadline_factor must be > 0, got "
                             f"{fed.deadline_factor}")
        self.population = make_population(fed.population, fed.n_clients,
                                          fed.seed)
        # the reference fleet with uniform weighting can never produce
        # ragged work or non-uniform weights -> the unmasked, unweighted
        # round. Exception: a deadline policy with deadline_factor <= 1
        # can bind even on the reference fleet (every client's
        # full-work time IS the reference time).
        deadline_can_bind = (fed.straggler_policy != "wait"
                             and fed.deadline_factor <= 1.0)
        self._hetero = (not self.population.is_reference) \
            or fed.weighting != "uniform" or deadline_can_bind
        if params is not None:
            device = tree_leaves(params)[0].device
        gen = torch.Generator(device=device).manual_seed(fed.seed)
        self.params = params if params is not None \
            else T.init_params(cfg, gen, dtype)
        if lora is None:
            lora = T.init_lora(cfg, gen, rank=fed.lora_rank)
        self.lora = self.strategy.init_lora(self.params, lora)
        # cohort-sampling stream: keyed tuple entropy, isolated from every
        # other consumer of fed.seed by its "cohort" label
        self.rng = keyed_rng(fed.seed, "cohort")
        self._n_sample = max(1, int(fed.n_clients * fed.sample_frac))
        self.device = tree_leaves(self.params)[0].device
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh={mesh!r}: pass a DeviceMesh "
                            f"(launch.mesh.resolve_mesh names them)")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run "
                             f"params on {self.device}")
        self.mesh = mesh
        self._placed = (None, None)      # (params, their placed copy)

    def _eval(self, cfg, params, lora, batch):
        with torch.no_grad():
            _, m = T.loss_fn(cfg, params, lora, batch)
        return float(m["loss"]), float(m["acc"])

    def _to_device(self, batches):
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batches.items()}

    # ---- mesh placement -------------------------------------------------
    def _place_model(self, spec):
        """The round's (params, lora) on the mesh, by the FSDP×TP rules;
        a stage's params are placed once and kept while the strategy
        hands out the same tree. As they are without a mesh."""
        if self.mesh is None:
            return spec.params, spec.lora
        if self._placed[0] is not spec.params:
            self._placed = (spec.params, shd.place(
                spec.params, shd.params_shardings(self.mesh, spec.params)))
        return self._placed[1], shd.place(
            spec.lora, shd.params_shardings(self.mesh, spec.lora))

    def _local_clients(self, tree):
        """This rank's shard of a tree with a leading sampled-client axis
        (the whole tree without a mesh)."""
        if self.mesh is None:
            return tree
        spec = client_spec(self.mesh, self._n_sample)
        return tree_map(lambda t: shd.local_part(
            self.mesh, spec + (None,) * (t.dim() - 1), t), tree)

    # ---- host-side round prep -------------------------------------------
    def _host_batches(self, rnd: int):
        """Sample this round's clients and build their batches on the
        host (numpy); returns ``(clients, batches)``: one ``rng.choice``
        call per round on the dedicated ``keyed_rng(seed, "cohort")``
        stream, batches keyed on ``(seed, round)``."""
        fed = self.fed
        clients = self.rng.choice(fed.n_clients, self._n_sample,
                                  replace=False)
        return clients, client_round_batches(
            self.data, clients, fed.k_local, fed.local_batch, fed.seq,
            seed=(fed.seed, rnd))

    def _plan(self, spec, clients, rnd):
        """This round's heterogeneity realization (pure numpy; the
        ``uniform`` fleet yields full work, no drops, and uniform
        weights). Transfer terms use the strategy's payload hooks so the
        clock agrees with the comm-bytes accounting."""
        fed, strat = self.fed, self.strategy
        return plan_round(
            self.population, clients, rnd,
            k_local=fed.k_local,
            step_flops=_step_flops(spec.params, fed.local_batch, fed.seq),
            up_bytes=strat.uplink_payload_bytes(spec),
            down_bytes=strat.downlink_payload_bytes(spec),
            policy=fed.straggler_policy, weighting=fed.weighting,
            deadline_factor=fed.deadline_factor,
            batch=fed.local_batch, seq=fed.seq)

    # ---- main loop ------------------------------------------------------
    def run(self, progress: Optional[Callable] = None) -> List[RoundLog]:
        fed, strat = self.fed, self.strategy
        if fed.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got "
                             f"{fed.eval_every}")
        logs: List[RoundLog] = []
        n_sample = self._n_sample
        eval_batch = self._to_device(self.data.eval_batch(16, fed.seq))

        state = strat.init_state(self.params, self.lora)
        rounds = list(strat.build_rounds(state))
        n_rounds = len(rounds)
        stage_prev = -1
        ev_loss = ev_acc = None          # carried forward between evals
        sim_time = 0.0                   # cumulative virtual wall-clock
        for rnd, (stage, capn) in enumerate(rounds):
            clients, batches = self._host_batches(rnd)
            if stage != stage_prev:
                strat.on_stage(state, stage)
                stage_prev = stage
            spec = strat.local_spec(state)
            plan = self._plan(spec, clients, rnd)
            if not self._hetero and (plan.n_dropped
                                     or plan.total_steps
                                     != n_sample * fed.k_local):
                # the uniform round ignores the plan, so a plan that
                # deviates from full uniform work must never reach it
                raise RuntimeError(
                    "internal: round plan deviates from full work but "
                    "the uniform round program is running "
                    f"(policy={fed.straggler_policy!r}, "
                    f"deadline_factor={fed.deadline_factor})")
            sim_time += plan.duration_s

            # ---- local training + aggregation ----
            lr = strat.client_lr(stage)
            dev_batches = self._local_clients(self._to_device(batches))
            params_p, lora_p = self._place_model(spec)
            round_fn, aux = make_round_program(strat, state, spec.cfg,
                                               n_sample, self.mesh)
            hetero = (self._local_clients(torch.as_tensor(plan.step_mask)),
                      plan.weights) if self._hetero else ()
            new_lora = round_fn(params_p, lora_p, dev_batches, lr, *hetero)
            if self.mesh is not None:
                new_lora = shd.gathered(new_lora)
            new_lora = strat.post_round(state, new_lora)

            # ---- eval (every eval_every rounds; last round always) ----
            if rnd % fed.eval_every == 0 or rnd == n_rounds - 1:
                ev_loss, ev_acc = self._eval(spec.cfg, params_p,
                                             new_lora, eval_batch)

            n_kept = int(plan.kept.sum())
            logs.append(RoundLog(
                round=rnd, stage=stage, capacity=capn,
                eval_loss=ev_loss, eval_acc=ev_acc,
                # dropped stragglers never upload; every sampled client
                # still downloaded the round's adapters
                comm_bytes_up=strat.uplink_bytes(aux["up"], n_kept),
                comm_bytes_down=strat.downlink_bytes(new_lora, n_sample),
                flops=_round_flops(spec.params, plan.total_steps,
                                   fed.local_batch, fed.seq),
                memory_bytes=_memory_bytes(spec.params, new_lora,
                                           fed.local_batch, fed.seq,
                                           spec.cfg),
                sim_time_s=sim_time,
                n_dropped=plan.n_dropped,
            ))
            if progress:
                progress(logs[-1])

        self.lora = strat.finalize(state)
        return logs
