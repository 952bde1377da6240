"""Heterogeneous-client execution: device profiles, named fleets,
straggler policies and the virtual wall-clock (the port's own copy of
the JAX package's ``repro.federated.heterogeneity``, pure numpy, kept
line for line so plans are ``array_equal``).

Cross-device FL is defined by *system* heterogeneity (device-speed
skew, stragglers, partial work) at least as much as by statistical
heterogeneity; the federated-LLM survey (arXiv:2503.12016) and the
framework comparison (arXiv:2501.04436) both call it the binding
constraint. This module makes it a first-class simulation axis:

* :class:`DeviceProfile` — one client's hardware: relative compute
  speed (1.0 = the reference edge device, ``REF_FLOPS_PER_S``),
  up/down bandwidth in bytes/s, and availability (P(client shows up
  for a round it was sampled in)).
* :class:`ClientPopulation` — a named fleet of per-client profiles.
  Profiles are drawn from a per-client ``SeedSequence((seed, client))``
  stream (like ``data.synthetic.client_rng``), so a client's hardware
  never depends on the sampling order or fleet-construction order.
* :func:`plan_round` — the host-side realization of one round: which
  sampled clients participate, how many of the ``k_local`` steps each
  one actually runs (a step *mask* keeps shapes static inside the
  client's K-step loop), the aggregation-weight vector, and the round's
  virtual duration.

Straggler policies (``FedConfig.straggler_policy``):

* ``wait``                — the server waits for every sampled client;
  round time is the slowest client's full-work time (classic FedAvg).
* ``accept-partial``      — a deadline of ``deadline_factor ×`` the
  reference device's full-work time; each client runs as many local
  steps as fit before it and uploads the partial result (masked steps
  contribute nothing; weighting can account for the smaller work).
* ``drop-after-deadline`` — same deadline, but clients that cannot
  finish ALL ``k_local`` steps in time are dropped: zero aggregation
  weight, no uplink, round time pinned at the deadline.

Weighting modes (``FedConfig.weighting``) produce the *coefficient
vector* ``w`` consumed by the aggregators (``new = g + Σ_c w_c (x_c -
g)``): ``uniform`` (equal over kept clients), ``examples``
(example-count-weighted FedAvg — weight ∝ tokens actually processed),
and ``fednova`` (FedNova-style step normalization: per-client deltas
divided by their local step count, rescaled by the effective step count
``τ_eff = Σ p_c τ_c``, removing the objective-inconsistency bias of
naive averaging under ragged local work).

Everything here is pure numpy on the host and fully deterministic in
``(seed, client, round)`` — the traced round program only ever sees the
resulting mask/weight arrays as operands.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import keyed_rng

#: reference edge device: ~1 TFLOP/s effective training throughput
#: (Jetson-Orin-class), 1 Gbit/s symmetric link. ``compute_speed`` and
#: the bandwidth fields of DeviceProfile are expressed relative to /in
#: the same units as these constants. The link is deliberately fat
#: relative to compute: LoRA keeps adapter payloads small (that's the
#: point), so in this setting COMPUTE is the straggler axis — a
#: 100 Mbit/s reference made toy-scale rounds comm-dominated and let a
#: bandwidth tail drop entire fleets regardless of their speed.
REF_FLOPS_PER_S = 1.0e12
REF_BANDWIDTH = 125e6           # bytes/s (1 Gbit/s)

POLICIES = ("wait", "accept-partial", "drop-after-deadline")
WEIGHTINGS = ("uniform", "examples", "fednova")


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One client's hardware, relative to the reference edge device."""
    compute_speed: float = 1.0       # x REF_FLOPS_PER_S
    up_bw: float = REF_BANDWIDTH     # bytes/s
    down_bw: float = REF_BANDWIDTH   # bytes/s
    availability: float = 1.0        # P(participates when sampled)


REFERENCE = DeviceProfile()


def _client_stream(seed: int, client: int) -> np.random.RandomState:
    """Per-client profile stream keyed on ``(seed, client)`` only —
    sample-order-independent, same recipe as the data streams (the
    trailing tag keeps it disjoint from them)."""
    return keyed_rng(seed, client, 0x5F1EE7)


def _round_stream(seed: int, client: int, rnd: int) -> np.random.RandomState:
    """Per-(client, round) stream for availability draws — independent
    of both the data stream and the profile stream."""
    return keyed_rng(seed, client, rnd, 0xA7A11)


# ---------------------------------------------------------------------------
# named fleets
# ---------------------------------------------------------------------------

_FLEETS: Dict[str, Callable[[np.random.RandomState], DeviceProfile]] = {}


def register_fleet(name: str,
                   fn: Callable[[np.random.RandomState], DeviceProfile]
                   ) -> None:
    """Add a fleet: ``fn(rng) -> DeviceProfile`` draws ONE
    client's profile from its private stream."""
    if name in _FLEETS:
        raise ValueError(f"fleet {name!r} already registered")
    _FLEETS[name] = fn


def available_fleets() -> List[str]:
    return sorted(_FLEETS)


def _uniform(rng: np.random.RandomState) -> DeviceProfile:
    return REFERENCE


def _tiered3(rng: np.random.RandomState) -> DeviceProfile:
    """Three device tiers (think: phone / laptop / workstation): slow
    and bandwidth-starved, reference, and fast with a fat pipe."""
    tier = rng.choice(3, p=[0.3, 0.5, 0.2])
    speed = (0.25, 1.0, 2.0)[tier]
    bw = REF_BANDWIDTH * (0.25, 1.0, 4.0)[tier]
    return DeviceProfile(compute_speed=speed, up_bw=bw, down_bw=bw)


def _pareto_edge(rng: np.random.RandomState) -> DeviceProfile:
    """Heavy-tailed edge fleet: most devices are slow, a few are fast
    (Pareto-distributed speed and bandwidth, independently drawn). The
    heavy tail lives mainly in COMPUTE speed — bandwidth floors stay
    within ~4x of reference so raggedness comes from slow training, not
    from links that could never ship even a LoRA payload."""
    speed = float(np.clip(0.25 * (1.0 + rng.pareto(1.5)), 0.25, 8.0))
    up = REF_BANDWIDTH * float(np.clip(0.25 * (1.0 + rng.pareto(1.5)),
                                       0.25, 4.0))
    down = REF_BANDWIDTH * float(np.clip(0.33 * (1.0 + rng.pareto(1.5)),
                                         0.33, 4.0))
    return DeviceProfile(compute_speed=speed, up_bw=up, down_bw=down)


def _flaky(rng: np.random.RandomState) -> DeviceProfile:
    """Reference hardware, unreliable participation: each client keeps
    a private availability in [0.5, 0.95]."""
    return DeviceProfile(availability=float(0.5 + 0.45 * rng.rand()))


register_fleet("uniform", _uniform)
register_fleet("tiered-3", _tiered3)
register_fleet("pareto-edge", _pareto_edge)
register_fleet("flaky", _flaky)


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """A named fleet: one :class:`DeviceProfile` per client."""
    name: str
    seed: int
    profiles: Tuple[DeviceProfile, ...]

    @property
    def n_clients(self) -> int:
        return len(self.profiles)

    @property
    def is_reference(self) -> bool:
        """True iff every client is exactly the reference device — the
        degenerate fleet under which ragged work and weighting can never
        engage (the engine keeps the legacy bit-exact round program)."""
        return all(p == REFERENCE for p in self.profiles)


def make_population(name: str, n_clients: int, seed: int
                    ) -> ClientPopulation:
    try:
        fn = _FLEETS[name]
    except KeyError:
        raise ValueError(f"unknown population {name!r}; "
                         f"available: {', '.join(available_fleets())}") \
            from None
    profiles = tuple(fn(_client_stream(seed, c)) for c in range(n_clients))
    return ClientPopulation(name=name, seed=seed, profiles=profiles)


# ---------------------------------------------------------------------------
# per-round realization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One round's host-side realization over the sampled clients."""
    clients: Tuple[int, ...]
    k_steps: np.ndarray         # (C,) int — local steps each client runs
    kept: np.ndarray            # (C,) bool — contributes to aggregation
    weights: np.ndarray         # (C,) float32 aggregation coefficients
    step_mask: np.ndarray       # (C, K) float32 — 1 for executed steps
    duration_s: float           # virtual wall-clock time of this round
    deadline_s: float           # the policy deadline (inf for "wait")

    @property
    def n_dropped(self) -> int:
        return int(len(self.clients) - self.kept.sum())

    @property
    def total_steps(self) -> int:
        return int(self.k_steps.sum())


def aggregation_weights(weighting: str, kept: np.ndarray,
                        k_steps: np.ndarray, batch: int, seq: int
                        ) -> np.ndarray:
    """The per-client coefficient vector ``w`` for ``new = g +
    Σ_c w_c (x_c - g)``. Dropped clients get exactly 0; if every client
    dropped, all-zero weights leave the global adapters untouched."""
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown weighting {weighting!r}; "
                         f"available: {', '.join(WEIGHTINGS)}")
    kept_f = kept.astype(np.float64)
    if weighting == "uniform":
        w = kept_f / kept_f.sum() if kept_f.sum() else kept_f
    else:
        ex = kept_f * k_steps * batch * seq     # examples processed
        total = ex.sum()
        if total == 0:
            w = ex
        elif weighting == "examples":
            w = ex / total
        else:                                    # fednova
            p = ex / total
            tau = np.maximum(k_steps, 1).astype(np.float64)
            tau_eff = float((p * tau).sum())
            w = tau_eff * p / tau
    return w.astype(np.float32)


def plan_round(population: ClientPopulation, clients: Sequence[int],
               rnd: int, *, k_local: int, step_flops: float,
               up_bytes: int, down_bytes: int, policy: str,
               weighting: str, deadline_factor: float, batch: int,
               seq: int) -> RoundPlan:
    """Realize one round: per-client step counts, kept mask, weights,
    step mask, and the round's virtual duration.

    ``step_flops`` is the FLOPs of ONE local step on the round's
    (sub)model; ``up_bytes``/``down_bytes`` the adapter payload each
    way. A client's full-work time is

        t_c = down/down_bw_c + k_local · step_flops/(speed_c · REF)
              + up/up_bw_c

    and the policy deadline is ``deadline_factor ×`` the reference
    device's full-work time.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown straggler_policy {policy!r}; "
                         f"available: {', '.join(POLICIES)}")
    clients = tuple(int(c) for c in clients)
    profs = [population.profiles[c] for c in clients]
    speed = np.array([p.compute_speed for p in profs], np.float64)
    t_step = step_flops / (speed * REF_FLOPS_PER_S)          # (C,)
    t_comm = np.array([down_bytes / p.down_bw + up_bytes / p.up_bw
                       for p in profs], np.float64)
    t_full = t_comm + k_local * t_step
    t_ref = (down_bytes + up_bytes) / REF_BANDWIDTH \
        + k_local * step_flops / REF_FLOPS_PER_S
    deadline = math.inf if policy == "wait" \
        else float(deadline_factor) * t_ref

    avail = np.array([_round_stream(population.seed, c, rnd).rand()
                      < population.profiles[c].availability
                      for c in clients], bool)

    if policy == "accept-partial":
        budget = np.maximum(deadline - t_comm, 0.0)
        k = np.minimum(np.floor(budget / t_step).astype(int), k_local)
        k = np.where(avail, np.maximum(k, 0), 0)
        kept = k > 0
        t_act = t_comm + k * t_step
        # a client that could not participate at all forces the server
        # to wait out the deadline; otherwise the round ends when the
        # slowest (possibly step-cut) upload lands
        duration = float(np.max(t_act, initial=0.0, where=kept)) \
            if kept.all() else deadline
    elif policy == "drop-after-deadline":
        kept = avail & (t_full <= deadline)
        k = np.where(kept, k_local, 0)
        duration = float(np.max(t_full, initial=0.0, where=kept)) \
            if kept.all() else deadline
    else:                                                    # wait
        kept = avail
        k = np.where(kept, k_local, 0)
        duration = float(np.max(t_full, initial=0.0, where=kept))

    weights = aggregation_weights(weighting, kept, k, batch, seq)
    mask = (np.arange(k_local)[None, :] < k[:, None]).astype(np.float32)
    return RoundPlan(clients=clients, k_steps=k.astype(int), kept=kept,
                     weights=weights, step_mask=mask,
                     duration_s=float(duration),
                     deadline_s=float(deadline))
